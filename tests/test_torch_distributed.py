"""Multi-process drills of the port, mirroring tests/test_distributed.py: two
OS processes join a ``torch.distributed`` group with the ``gloo`` backend on
the CPU, two CPU shards each (four in the group), and run

  * float: ``sharded_core_search`` across the process boundary (candidates
    mode, the maps merged after an ``all_gather``), and
    ``sharded_search_topk`` in pixels mode (maps gathered along the rows)
    and time mode (partial sums ``all_reduce``d);
  * encoded: the same search over uint8 codes (K5's twin per shard);
  * ckpt: ``checkpointed_core_search`` over a sharded per-tile search, run
    fresh and then resumed after the test deleted a tile: process 0's
    broadcast finished-tile set keeps both processes on one branch;
  * patches: each process searches the patches ``assign_patches_to_hosts``
    gives it and writes one results file a patch;
  * mesh: ``build_mesh()`` with no devices, with two cards faked in each
    process: one shard a process, on the card the process is bound to.

Every result equals the single-process search (time mode: within the
float64 bound of tests/test_torch_search_kernel.py). The worker is this file
run as a script; it imports no JAX.
"""

import os
import socket
import subprocess
import sys

import numpy as np

T, H, W, C = 4, 16, 16, 8
PHASES = "float,encoded,ckpt,patches"


def make_inputs():
    """The inputs of the JAX package's drills (tests/utils/distributed_worker.py)."""
    rng = np.random.default_rng(3)
    psi = rng.normal(0, 1, (T, H, W)).astype(np.float32)
    phi = rng.uniform(0.5, 2.0, (T, H, W)).astype(np.float32)
    valid = np.ones((T, H, W), np.uint8)
    times = np.arange(T) * 0.5
    vxs = rng.uniform(-3, 3, C).astype(np.float32)
    vys = rng.uniform(-3, 3, C).astype(np.float32)
    return psi, phi, valid, times, vxs, vys


def _encoded_planes(psi, phi, times):
    from kbmod_tpu_torch.ops.psi_phi import PsiPhiArray, fill_psi_phi_array
    from kbmod_tpu_torch.ops.search import EncodedPlanes

    arr = PsiPhiArray()
    fill_psi_phi_array(arr, 1, list(psi), list(phi), times, device="cpu")
    return EncodedPlanes(arr.psi, arr.phi, arr.encode_meta(), arr.code_pairs())


def _worker(pid, port, out_dir, phases):
    import torch

    from kbmod_tpu_torch.parallel import (
        assign_patches_to_hosts,
        build_mesh,
        initialize_distributed,
        is_distributed,
        sharded_core_search,
        sharded_search_topk,
    )

    initialize_distributed(coordinator_address=f"127.0.0.1:{port}", num_processes=2, process_id=pid, device="cpu")
    initialize_distributed(coordinator_address=f"127.0.0.1:{port}", num_processes=2, process_id=pid, device="cpu")
    assert is_distributed() and torch.distributed.get_backend() == "gloo"
    assert assign_patches_to_hosts(5) == ([0, 2, 4] if pid == 0 else [1, 3])
    mesh = build_mesh(devices=["cpu", "cpu"])
    assert (mesh.size, mesh.rank, mesh.world_size) == (4, pid, 2)

    psi, phi, valid, times, vxs, vys = make_inputs()
    planes = tuple(torch.as_tensor(a) for a in (psi, phi, valid))
    meta = dict(x_min=0, x_max=W, y_min=0, y_max=H, results_per_pixel=2)

    def save(name, arrays):
        if pid == 0:
            np.savez(os.path.join(out_dir, name), **arrays)

    if "float" in phases:
        save("res_float.npz", sharded_core_search(*planes, times, vxs, vys, mesh, **meta))
        from kbmod_tpu_torch.ops.search import trajectory_offsets

        dxs, dys = trajectory_offsets(vxs, vys, times)
        for mode in ("pixels", "time"):
            lh, idx = sharded_search_topk(*planes, dxs, dys, mesh, x_min=0, x_max=W, y_min=0, y_max=H,
                                          k_results=3, shard_mode=mode)
            save(f"maps_{mode}.npz", {"lh": lh.numpy(), "idx": idx.numpy()})
        print(f"proc {pid} float OK", flush=True)

    if "encoded" in phases:
        enc = _encoded_planes(psi, phi, times)
        save("res_encoded.npz", sharded_core_search(enc, None, None, times, vxs, vys, mesh, **meta))
        print(f"proc {pid} encoded OK", flush=True)

    if "ckpt" in phases:
        from kbmod_tpu_torch.search.checkpoint import checkpointed_core_search

        def tile_fn(psi_, phi_, valid_, times_, vxs_, vys_, x0, x1, y0, y1, rpp, **kw):
            return sharded_core_search(psi_, phi_, valid_, times_, vxs_, vys_, mesh, x_min=x0, x_max=x1,
                                       y_min=y0, y_max=y1, results_per_pixel=rpp, **kw)

        timings = {}
        res = checkpointed_core_search(*planes, times, vxs, vys, 0, W, 0, H, 2, os.path.join(out_dir, "ckpt"),
                                       tile_rows=4, search_fn=tile_fn, timings=timings)
        save("res_ckpt.npz", res)
        print(f"proc {pid} ckpt OK, tiles loaded {timings['tiles_loaded']}", flush=True)

    if "patches" in phases:
        # Patch-parallel: no collectives; each process searches its own
        # row patches and writes one results file a patch.
        from kbmod_tpu_torch.ops.search import core_search
        from kbmod_tpu_torch.results import Results
        from kbmod_tpu_torch.search.trajectory_list import TrajectoryList

        rows = H // 4
        for patch in assign_patches_to_hosts(4):
            part = core_search(*planes, times, vxs, vys, 0, W, patch * rows, (patch + 1) * rows, 2)
            res = Results.from_trajectories(TrajectoryList(part))
            res.set_mjd_utc_mid(np.asarray(times) + 57000.0)
            res.write_table(os.path.join(out_dir, f"patch_{patch}.ecsv"), overwrite=True)
        print(f"proc {pid} patches OK", flush=True)

    if "mesh" in phases:
        # The group runs on the CPU; fake two visible cards, this process
        # bound to the one its rank names.
        from unittest import mock

        from kbmod_tpu_torch.parallel.sharded import search_mesh

        with mock.patch.object(torch.cuda, "device_count", lambda: 2), \
                mock.patch.object(torch.cuda, "current_device", lambda: pid):
            own = build_mesh()
            auto = search_mesh("cuda")
        assert own.devices == [torch.device("cuda", pid)], own
        assert (own.size, own.rank, own.world_size) == (2, pid, 2)
        assert auto is not None and auto.devices == own.devices
        print(f"proc {pid} mesh OK", flush=True)

    torch.distributed.destroy_process_group()
    print(f"proc {pid} OK", flush=True)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(out_dir, phases):
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env["OMP_NUM_THREADS"] = "1"
    procs = [
        subprocess.Popen([sys.executable, __file__, str(pid), str(port), out_dir, phases],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
        for pid in (0, 1)
    ]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for pid, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{log[-3000:]}"
        assert f"proc {pid} OK" in log
    return logs


def _single():
    import torch

    from kbmod_tpu_torch.ops.search import core_search

    psi, phi, valid, times, vxs, vys = make_inputs()
    planes = tuple(torch.as_tensor(a) for a in (psi, phi, valid))
    return planes, (times, vxs, vys), core_search(*planes, times, vxs, vys, 0, W, 0, H, 2)


def _assert_equal(path, expected):
    with np.load(path) as got:
        for key in expected:
            np.testing.assert_array_equal(got[key], expected[key], err_msg=key)


def test_two_process_drills(tmp_path):
    import torch

    from kbmod_tpu_torch.ops.search import core_search, trajectory_offsets
    from kbmod_tpu_torch.ops.search_kernel import search_topk
    from kbmod_tpu_torch.results import Results
    from test_torch_search_kernel import _lh_of, assert_lh_match

    out = str(tmp_path)
    logs = _launch(out, PHASES)
    assert all("tiles loaded 0" in log for log in logs)
    planes, (times, vxs, vys), exp = _single()

    _assert_equal(os.path.join(out, "res_float.npz"), exp)
    psi, phi, valid = (a.numpy() for a in planes)
    dxs, dys = trajectory_offsets(vxs, vys, times)
    kw = dict(x_min=0, x_max=W, y_min=0, y_max=H, k_results=3)
    maps = search_topk(*planes, torch.as_tensor(dxs), torch.as_tensor(dys), 0.0, 0.0, **kw)
    with np.load(os.path.join(out, "maps_pixels.npz")) as got:
        np.testing.assert_array_equal(got["lh"], maps[0].numpy())
        np.testing.assert_array_equal(got["idx"], maps[1].numpy())
    with np.load(os.path.join(out, "maps_time.npz")) as got:
        assert_lh_match((got["lh"], got["idx"]), (maps[0].numpy(), maps[1].numpy()),
                        *_lh_of(psi, phi, valid, dxs, dys, 0.0, 0.0, kw))

    enc = _encoded_planes(psi, phi, times)
    _assert_equal(os.path.join(out, "res_encoded.npz"), core_search(enc, None, None, times, vxs, vys, 0, W, 0, H, 2))

    # Process 0 wrote every tile; the result is the single-process search.
    tiles = sorted(f for f in os.listdir(os.path.join(out, "ckpt")) if f.startswith("tile_"))
    assert tiles == ["tile_0_4.npz", "tile_12_16.npz", "tile_4_8.npz", "tile_8_12.npz"]
    _assert_equal(os.path.join(out, "res_ckpt.npz"), exp)

    # Patch-parallel: the four patch files, read back with the port's
    # Results, hold the full-frame search's rows.
    parts = [Results.read_table(os.path.join(out, f"patch_{i}.ecsv")) for i in range(4)]
    rows = sorted((int(x), int(y), float(lh)) for r in parts for x, y, lh in zip(r["x"], r["y"], r["likelihood"]))
    assert rows == sorted(zip(exp["x"].tolist(), exp["y"].tolist(), exp["lh"].astype(float).tolist()))


def test_two_process_default_mesh(tmp_path, monkeypatch):
    """In a group, the default mesh is each process's own card: as many
    shards as processes (one card each), not every card in every process;
    KB_SHARDED=auto then shards a CUDA search over them."""
    monkeypatch.delenv("KB_SHARDED", raising=False)
    logs = _launch(str(tmp_path), "mesh")
    assert all(f"proc {pid} mesh OK" in log for pid, log in enumerate(logs))


def test_two_process_ckpt_resume(tmp_path):
    """Resume across the process boundary: run once, delete a mid-stack
    tile, run again: both processes load the same three tiles (process 0's
    broadcast), recompute the deleted one and reproduce the result."""
    out = str(tmp_path)
    _launch(out, "ckpt")
    os.remove(os.path.join(out, "ckpt", "tile_4_8.npz"))
    logs = _launch(out, "ckpt")
    assert all("ckpt OK, tiles loaded 3" in log for log in logs)
    _assert_equal(os.path.join(out, "res_ckpt.npz"), _single()[2])
    # Process 0 recomputed the deleted tile and wrote it again.
    assert os.path.exists(os.path.join(out, "ckpt", "tile_4_8.npz"))


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    _worker(int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4].split(","))
