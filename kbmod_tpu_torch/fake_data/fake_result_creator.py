"""Generate fake Results tables for testing filters and IO.

Copy of the JAX package's fake_data/fake_result_creator.py: the same
``rng`` gives the same tables.
Behavior-compatible with the reference's
kbmod.fake_data.fake_result_creator (src/kbmod/fake_data/
fake_result_creator.py): random trajectory rows, optional psi/phi curves,
obs_valid masks, and stamps.
"""

import numpy as np

from kbmod_tpu_torch.results import Results

__all__ = [
    "make_fake_trajectories",
    "make_fake_results",
    "add_fake_psi_phi_to_results",
    "add_fake_obs_valid_to_results",
    "add_fake_coadds_to_results",
]


def make_fake_trajectories(num_results, width, height, rng=None):
    """Random in-bounds trajectories sorted by descending likelihood."""
    from kbmod_tpu_torch.search import Trajectory

    rng = np.random.default_rng() if rng is None else rng
    lh = np.sort(rng.uniform(5.0, 150.0, num_results))[::-1]
    trjs = []
    for i in range(num_results):
        trjs.append(
            Trajectory(
                x=int(rng.integers(0, width)),
                y=int(rng.integers(0, height)),
                vx=float(rng.uniform(-100, 100)),
                vy=float(rng.uniform(-100, 100)),
                flux=float(rng.uniform(50, 500)),
                lh=float(lh[i]),
                obs_count=int(rng.integers(5, 30)),
            )
        )
    return trjs


def make_fake_results(num_times, width, height, num_results, rng=None):
    """A fake Results table with trajectories and matching psi/phi curves."""
    rng = np.random.default_rng() if rng is None else rng
    trjs = make_fake_trajectories(num_results, width, height, rng=rng)
    results = Results.from_trajectories(trjs)
    add_fake_psi_phi_to_results(results, num_times, rng=rng)
    add_fake_obs_valid_to_results(results, num_times, rng=rng)
    results.set_mjd_utc_mid(57130.0 + np.arange(num_times) * 0.05)
    return results


def add_fake_psi_phi_to_results(results, num_times, rng=None):
    """Attach random positive psi/phi curves consistent with each row's
    likelihood scale."""
    rng = np.random.default_rng() if rng is None else rng
    n = len(results)
    phi = rng.uniform(0.5, 2.0, (n, num_times)).astype(np.float32)
    base = np.asarray(results["likelihood"], dtype=np.float32)[:, None] / np.sqrt(num_times)
    psi = (base * rng.uniform(0.6, 1.4, (n, num_times))).astype(np.float32) * np.sqrt(phi)
    results.add_psi_phi_data(psi, phi)
    return results


def add_fake_obs_valid_to_results(results, num_times, valid_frac=0.9, rng=None):
    """Attach a random obs_valid mask (each row keeps >= 1 observation)."""
    rng = np.random.default_rng() if rng is None else rng
    n = len(results)
    obs_valid = rng.uniform(size=(n, num_times)) < valid_frac
    obs_valid[np.arange(n), rng.integers(0, num_times, n)] = True
    results.update_obs_valid(obs_valid)
    return results


def add_fake_coadds_to_results(results, radius, coadd_types=("mean",), rng=None):
    """Attach Gaussian-blob coadd stamps."""
    rng = np.random.default_rng() if rng is None else rng
    n = len(results)
    size = 2 * radius + 1
    ax = np.arange(size) - radius
    xx, yy = np.meshgrid(ax, ax)
    blob = np.exp(-0.5 * (xx**2 + yy**2) / 2.0).astype(np.float32)
    for ctype in coadd_types:
        noise = rng.normal(0, 0.05, (n, size, size)).astype(np.float32)
        results.table[f"coadd_{ctype}"] = blob[None] + noise
    return results
