"""K6: the design micro-benchmark of K5's packed inner loop, as a CUDA
kernel and its plain PyTorch twin.

``exactrow_accumulate`` replaces the TPU kernel that ``make_kernel(mode)``
returns in the JAX package's scripts/exactrow_microbench.py:49. Every int32
word of ``buf`` packs two pixels' (psi, phi) uint8 codes, as the port's
uint8 code pairs read as 32-bit words do; the kernel sums the words' 16-bit
fields over NG groups x T time steps x G members with a row roll and a lane
roll per slot (the function is written out in ``csrc/exactrow_microbench.cu``
and in :func:`exactrow_accumulate_plain`). Modes A, B and C compute the same
result and differ only in where the extract and the roll sit. The kernel's
blocks each own a tile of K6_TILE_ROWS rows x K6_TILE_WORDS words, a thread
a run of K6_RUN words, and stage each (group, t)'s window rolled by row and
lane (``csrc/exactrow_microbench.cu``). On a CUDA tensor the wrapper
launches the kernel or raises; on a CPU tensor it runs the twin.
"""

import ctypes

import torch

from kbmod_tpu_torch.ops import _build

MODES = ("A", "B", "C")
PAIR = 0x00FF00FF
FIELD = 0x00010001
_MASK32 = 0xFFFFFFFF
# The kernel's tile (rows, words) and a thread's run of words.
K6_TILE_ROWS, K6_TILE_WORDS, K6_RUN = 4, 512, 8

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "kb_exactrow": ([_P, _P, _I, _I, _I, _I, _I, _I, _P, _P], ctypes.c_int),
    "kb_exactrow_max_width": ([], ctypes.c_int),
    "kb_exactrow_blocks_per_sm": ([_I], ctypes.c_int),
    "kb_exactrow_tile": ([_I], ctypes.c_int),
}


def _check_args(tbl, buf, mode, group, th, check=True):
    if mode not in MODES:
        raise ValueError(f"exactrow: mode must be one of {MODES}, got {mode!r}")
    if tbl.dtype != torch.int32 or buf.dtype != torch.int32 or tbl.dim() != 2 or buf.dim() != 2:
        raise ValueError("exactrow: tbl (NG, 3T) and buf (rows, W4) must be 2-D int32")
    if tbl.device != buf.device:
        raise ValueError("exactrow: tbl and buf must lie on one device")
    NG, T3 = tbl.shape
    rows, W4 = buf.shape
    if T3 % 3 or T3 == 0 or NG == 0 or W4 == 0:
        raise ValueError(f"exactrow: tbl must be (NG, 3T) with NG, T >= 1, got {tuple(tbl.shape)}")
    if not 1 <= group <= 8:
        raise ValueError(f"exactrow: group must be 1..8, got {group}")
    T, SL = T3 // 3, th + 8
    if th < 1 or rows < SL:
        raise ValueError(f"exactrow: TH={th} needs buf rows >= TH + 8, got {rows}")
    if not check:
        return NG, T, W4
    rs, base, aln = tbl[:, :T], tbl[:, T : 2 * T], tbl[:, 2 * T :]
    if bool((rs < 0).any() | (rs >= SL).any()):
        raise ValueError(f"exactrow: row rolls must lie in [0, {SL})")
    if bool((base < 0).any() | (base > rows - SL).any()):
        raise ValueError(f"exactrow: window bases must lie in [0, {rows - SL}]")
    if bool((aln.abs() >= 1 << 30).any()):
        raise ValueError("exactrow: lane alignments must lie within +-2^30")
    return NG, T, W4


def exactrow_accumulate_plain(tbl, buf, mode="A", group=8, th=None):
    """Plain PyTorch twin of K6 (every mode computes this).

    tbl: (NG, 3T) int32 (row rolls, window bases, lane alignments); buf:
    (rows, W4) int32. ``th`` is the output's row count TH (default rows // 2
    - 16, since the JAX script's buffer holds 2 (TH + 16) rows). Returns out
    (TH, W4) int32, the wrapped uint32 sum over the groups.
    """
    exactrow_accumulate_plain.calls += 1
    th = _default_th(buf) if th is None else int(th)
    NG, T, W4 = _check_args(tbl, buf, mode, group, th)
    dev = buf.device
    SL = th + 8
    words = buf.to(torch.int64) & _MASK32
    tb = tbl.to(torch.int64)
    r = torch.arange(th, device=dev)
    c = torch.arange(W4, device=dev)
    out = torch.zeros((th, W4), dtype=torch.int64, device=dev)
    for t in range(T):
        rows = tb[:, T + t, None] + (r[None] + tb[:, t, None]) % SL  # (NG, TH)
        pw = words[rows]  # (NG, TH, W4)
        for gi in range(group):
            cols = (c[None] + tb[:, 2 * T + t, None] + gi) % W4  # (NG, W4)
            wm = torch.gather(pw, 2, cols[:, None, :].expand(NG, th, W4))
            pv = wm & PAIR
            fv = (wm >> 8) & PAIR
            ind = ((pv + PAIR) >> 8) & FIELD
            # acc_psi[0] is counted twice, as in the JAX script.
            out += ((2 if gi == 0 else 1) * pv + fv + ind).sum(dim=0)
    out &= _MASK32
    return torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32)


exactrow_accumulate_plain.calls = 0


def _default_th(buf):
    return buf.shape[0] // 2 - 16


def exactrow_accumulate(tbl, buf, mode="A", group=8, th=None, check=True):
    """K6 in mode A, B or C (arguments and result as
    :func:`exactrow_accumulate_plain`).

    CUDA tensors launch the kernel on the current stream and raise if it
    cannot run; CPU tensors take the twin. ``check=False`` skips the range
    checks of ``tbl``, which wait for the card: a timing loop passes it for
    a table that an earlier call checked."""
    if buf.device.type == "cpu":
        return exactrow_accumulate_plain(tbl, buf, mode, group, th)
    if buf.device.type != "cuda":
        raise ValueError(f"exactrow_accumulate: unsupported device {buf.device}")
    th = _default_th(buf) if th is None else int(th)
    NG, T, W4 = _check_args(tbl, buf, mode, group, th, check)
    lib = _build.load("exactrow_microbench", _SIGNATURES)
    if tuple(lib.kb_exactrow_tile(a) for a in range(3)) != (K6_TILE_ROWS, K6_TILE_WORDS, K6_RUN):
        raise RuntimeError("exactrow_accumulate: host and kernel disagree on the tile")
    if W4 > lib.kb_exactrow_max_width():
        raise ValueError(f"exactrow_accumulate: W4={W4} above the kernel's {lib.kb_exactrow_max_width()}")
    tbl = tbl.contiguous()
    buf = buf.contiguous()
    out = torch.zeros((th, W4), dtype=torch.int32, device=buf.device)
    with torch.profiler.record_function("kbmod K6 exactrow_accumulate"):
        err = lib.kb_exactrow(
            tbl.data_ptr(), buf.data_ptr(), NG, T, int(group), th, W4, ord(mode), out.data_ptr(),
            torch.cuda.current_stream(buf.device).cuda_stream,
        )
    _build.check(err, "exactrow_accumulate")
    exactrow_accumulate.launches += 1
    return out


exactrow_accumulate.launches = 0
