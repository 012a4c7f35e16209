"""Device resolution: CUDA unless the caller asks for the CPU; the card's
free memory."""

import torch


def resolve_device(device=None):
    """The torch.device an entry point runs on.

    ``None`` means CUDA. CUDA raises when no card is present: the port
    never falls back to the CPU on its own. Pass ``"cpu"`` to run the plain
    PyTorch versions of the kernels on the host.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "kbmod_tpu_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run on the host."
            )
    elif dev.type != "cpu":
        raise ValueError(f"Unsupported device {dev}: use 'cuda' or 'cpu'.")
    return dev


def device_free_bytes(device):
    """Free memory of a CUDA device: what cudaMemGetInfo reports free plus
    what PyTorch holds cached but unallocated."""
    free, _ = torch.cuda.mem_get_info(device)
    return free + torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
