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
from kbmod_tpu_torch.ops.exactrow_kernel import exactrow_accumulate, exactrow_accumulate_plain

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
