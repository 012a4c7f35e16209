"""K6, the packed inner-loop micro-benchmark: the port's twin against the
JAX package's Pallas kernel.

The JAX script (scripts/exactrow_microbench.py) runs its benchmark loop at
module level, so the test loads its ``make_kernel`` by parsing the file,
dropping that trailing ``for`` and executing the rest with the sizes set
through its environment variables; the file itself is not changed. The
kernel runs through ``pl.pallas_call(..., interpret=True)`` with the
script's specs. Tolerance: exact int32 equality (wrapping integer sums).
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from kbmod_tpu_torch.ops import exactrow_kernel
from kbmod_tpu_torch.ops.exactrow_kernel import (
    K6_RUN,
    K6_TILE_ROWS,
    K6_TILE_WORDS,
    exactrow_accumulate,
    exactrow_accumulate_plain,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO_ROOT, "scripts", "exactrow_microbench.py")
TH, W4, T, NG, G = 8, 16, 4, 3, 8


def _load_script(monkeypatch):
    for name, value in (("MB_TH", TH), ("MB_W4", W4), ("MB_T", T), ("MB_NG", NG)):
        monkeypatch.setenv(name, str(value))
    with open(SCRIPT) as f:
        tree = ast.parse(f.read(), filename=SCRIPT)
    assert isinstance(tree.body[-1], ast.For), "the script's trailing benchmark loop moved"
    tree.body = tree.body[:-1]
    ns = {"__name__": "exactrow_microbench_under_test", "__file__": SCRIPT}
    exec(compile(tree, SCRIPT, "exec"), ns)
    assert (ns["TH"], ns["W4"], ns["T"], ns["NG"], ns["G"]) == (TH, W4, T, NG, G)
    return ns


def _pallas(ns, mode, tbl, buf):
    f = pl.pallas_call(
        ns["make_kernel"](mode),
        out_shape=jax.ShapeDtypeStruct((TH, W4), jnp.int32),
        grid=(NG,),
        in_specs=[
            pl.BlockSpec(memory_space=pltpu.SMEM),
            pl.BlockSpec(memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((G, TH, W4), jnp.int32) for _ in range(3)],
        interpret=True,
    )
    return np.asarray(f(jnp.asarray(tbl), jnp.asarray(buf)))


def _inputs(draw):
    rows, SL = 2 * (TH + 16), TH + 8
    buf = np.random.default_rng(1).integers(0, 2**31 - 1, (rows, W4), dtype=np.int32)
    if draw == "script":
        tbl = np.random.default_rng(0).integers(0, 8, (NG, 3 * T), dtype=np.int32)
    else:
        # Wide shifts: any row roll, any window base, lane rolls past W4.
        rng = np.random.default_rng(7)
        tbl = np.concatenate(
            [
                rng.integers(0, SL, (NG, T)),
                rng.integers(0, rows - SL + 1, (NG, T)),
                rng.integers(0, 3 * W4, (NG, T)),
            ],
            axis=1,
        ).astype(np.int32)
    return tbl, buf


@pytest.mark.parametrize("mode", ["A", "B", "C"])
@pytest.mark.parametrize("draw", ["script", "wide"])
def test_twin_matches_pallas_interpret(monkeypatch, draw, mode):
    ns = _load_script(monkeypatch)
    tbl, buf = _inputs(draw)
    want = _pallas(ns, mode, tbl, buf)
    calls = exactrow_accumulate_plain.calls
    got = exactrow_accumulate(torch.as_tensor(tbl), torch.as_tensor(buf), mode, G, TH)
    assert exactrow_accumulate_plain.calls == calls + 1
    assert got.dtype == torch.int32 and tuple(got.shape) == (TH, W4)
    np.testing.assert_array_equal(got.numpy(), want)


def test_twin_wraps_mod_2_32():
    """Sums past 2^31 wrap as uint32: words with every field at 0xFF."""
    tbl = torch.zeros((5, 3), dtype=torch.int32)
    buf = torch.full((2 * (1 + 16), 3), -1, dtype=torch.int32)  # 0xFFFFFFFF
    got = exactrow_accumulate_plain(tbl, buf, "A", 8, 1)
    word = 0xFFFFFFFF
    pv = fv = word & 0x00FF00FF
    ind = ((pv + 0x00FF00FF) >> 8) & 0x00010001
    per_slot = 9 * pv + 8 * fv + 8 * ind
    want = (5 * per_slot) & 0xFFFFFFFF
    want = want - (1 << 32) if want >= 1 << 31 else want
    assert torch.equal(got, torch.full((1, 3), want, dtype=torch.int32))


def test_wrapper_checks_its_arguments():
    tbl, buf = (torch.as_tensor(a) for a in _inputs("script"))
    with pytest.raises(ValueError, match="mode"):
        exactrow_accumulate(tbl, buf, "D", G, TH)
    with pytest.raises(ValueError, match="group"):
        exactrow_accumulate(tbl, buf, "A", 9, TH)
    with pytest.raises(ValueError, match="int32"):
        exactrow_accumulate(tbl.to(torch.int64), buf, "A", G, TH)
    bad = tbl.clone()
    bad[0, 0] = TH + 8  # a row roll of SL
    with pytest.raises(ValueError, match="row rolls"):
        exactrow_accumulate(bad, buf, "A", G, TH)
    bad = tbl.clone()
    bad[1, T] = buf.shape[0] - TH - 7  # a window past the buffer's end
    with pytest.raises(ValueError, match="window bases"):
        exactrow_accumulate(bad, buf, "A", G, TH)
    with pytest.raises(ValueError, match="3T"):
        exactrow_accumulate(tbl[:, :-1], buf, "A", G, TH)


def test_default_rows_follow_the_script_buffer():
    tbl, buf = (torch.as_tensor(a) for a in _inputs("script"))
    assert torch.equal(exactrow_accumulate(tbl, buf, "C"), exactrow_accumulate(tbl, buf, "C", G, TH))


def test_script_imports_without_running_and_needs_a_card(capsys):
    from kbmod_tpu_torch.scripts import exactrow_microbench as mb

    assert capsys.readouterr().out == ""
    tbl, buf = mb.make_inputs(th=TH, w4=W4, t=T, ng=NG)
    assert tbl.shape == (NG, 3 * T) and buf.shape == (2 * (TH + 16), W4)
    assert np.array_equal(tbl.numpy(), _inputs("script")[0])
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present, so the script would run")
    launches = exactrow_kernel.exactrow_accumulate.launches
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mb.main(["A", "--th", str(TH), "--w4", str(W4), "--t", str(T), "--ng", str(NG)])
    assert exactrow_kernel.exactrow_accumulate.launches == launches


def _k6_replay(tbl, buf, mode, group, th, slices):
    """The new K6 (csrc/exactrow_microbench.cu) replayed in numpy: per block
    of K6_TILE_ROWS x K6_TILE_WORDS words and per slice of the groups, each
    (group, t)'s window staged with both rolls in the staging address (row
    r0 + rr + rs mod SL, words from column c0 + aln mod W4 on), then each
    thread's run of K6_RUN words summed from the staged row as the mode
    reads it, and the block's sums added into out (mod 2^32)."""
    NG, T3 = tbl.shape
    T, (rows, W4) = T3 // 3, buf.shape
    SL = th + 8
    P, F, M = 0x00FF00FF, 0x00010001, 0xFFFFFFFF
    words = buf.astype(np.int64) & M
    stage_w = K6_TILE_WORDS + 8 - 1
    out = np.zeros((th, W4), np.int64)
    run = np.arange(K6_TILE_WORDS // K6_RUN)[:, None] * K6_RUN + np.arange(K6_RUN)[None, :]  # (threads, j)
    for r0 in range(0, th, K6_TILE_ROWS):
        for c0 in range(0, W4, K6_TILE_WORDS):
            for z in range(slices):
                g0, g1 = z * NG // slices, (z + 1) * NG // slices
                tot = np.zeros((K6_TILE_ROWS,) + run.shape, np.int64)
                for pg in range(g0, g1):
                    for t in range(T):
                        rs, base, aln = (int(v) for v in tbl[pg, [t, T + t, 2 * T + t]])
                        start = (c0 + aln) % W4
                        k = np.arange(stage_w)
                        col = np.where(k + start >= W4, k + start - W4, k + start) if W4 >= stage_w else (start + k) % W4
                        stg = np.zeros((K6_TILE_ROWS, stage_w + 1), np.int64)  # the pitch's last word is never staged
                        for rr in range(min(K6_TILE_ROWS, th - r0)):
                            q = r0 + rr + rs
                            q = q - SL if q >= SL else q
                            stg[rr, :stage_w] = words[base + q, col]
                        for gi in range(group):
                            if mode == "A":  # a shared load a member-word, the index from scratch
                                w = stg[:, run + gi]
                                pv, fv = w & P, (w >> 8) & P
                                terms = pv + fv + (((pv + P) >> 8) & F)
                            else:  # the run's words loaded once; the member reads word j + gi
                                loaded = stg[:, run[:, :1] + np.arange(K6_RUN + 8)[None, :]]
                                pv_all, fv_all = loaded & P, (loaded >> 8) & P
                                if mode == "B":  # one extract a loaded word, three adds a member-word
                                    ind_all = ((pv_all + P) >> 8) & F
                                    sel = np.arange(K6_RUN) + gi
                                    pv, terms = pv_all[..., sel], pv_all[..., sel] + fv_all[..., sel] + ind_all[..., sel]
                                else:  # C: the extract a member-word
                                    w = loaded[..., np.arange(K6_RUN) + gi]
                                    pv, fv = w & P, (w >> 8) & P
                                    terms = pv + fv + (((pv + P) >> 8) & F)
                            tot = (tot + terms + (pv if gi == 0 else 0)) & M
                live_r = np.arange(K6_TILE_ROWS) < th - r0
                c = c0 + run
                for rr in np.flatnonzero(live_r):
                    keep = c < W4
                    np.add.at(out[r0 + rr], c[keep], tot[rr][keep])
    out &= M
    return np.where(out >= 1 << 31, out - (1 << 32), out).astype(np.int32)


@pytest.mark.parametrize("mode", ["A", "B", "C"])
@pytest.mark.parametrize("shape", [(8, 16, 3), (7, 601, 2), (5, 13, 5)])
def test_k6_replay_matches_twin(mode, shape):
    """The new K6's staging (rotated rows, words from the lane roll on, in
    tiles that do not divide TH and W4, a row narrower than one staged run)
    and register runs, replayed in numpy for every mode over wrap-around
    tables and group slices, equal the twin exactly, at G = 8 and G = 3."""
    th, w4, slices = shape
    rng = np.random.default_rng(th + w4)
    T, NG, rows = 3, 5, 2 * (th + 16)
    SL = th + 8
    buf = rng.integers(-(2**31), 2**31 - 1, (rows, w4), dtype=np.int64).astype(np.int32)
    tbl = np.concatenate(
        [rng.integers(0, SL, (NG, T)), rng.integers(0, rows - SL + 1, (NG, T)), rng.integers(-3 * w4, 3 * w4, (NG, T))],
        axis=1,
    ).astype(np.int32)
    for group in (8, 3):
        want = exactrow_accumulate_plain(torch.as_tensor(tbl), torch.as_tensor(buf), mode, group, th).numpy()
        np.testing.assert_array_equal(_k6_replay(tbl, buf, mode, group, th, slices), want)
