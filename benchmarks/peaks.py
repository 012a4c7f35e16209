"""Published peaks of the cards the benchmark runs on (NVIDIA's data sheet
of the H100 SXM, dense rates, at the full 700 W), by a substring of
``torch.cuda.get_device_name()``. A roofline share is stated against these,
with the card's power limit beside it."""

PEAKS = {
    "H100": {
        "fp32_flops": 67e12,  # outside the tensor cores; a multiply-add counts 2
        "int8_ops": 1979e12,
        "hbm_bytes": 3.35e12,
    },
}


def peaks(device_name):
    """The peak table of a card, or None for a card not listed."""
    for key, table in PEAKS.items():
        if key in device_name:
            return table
    return None
