"""Utilities for working with trajectories: vectorized position prediction,
RA/Dec conversions, least-squares fitting, and trajectory-set matching.

Port of the JAX package's trajectory_utils.py (API-compatible with the
reference's kbmod.trajectory_utils). The RA/Dec helpers only call methods of
the WCS object they are given; the port has no WCS of its own yet.
"""

import numpy as np

from kbmod_tpu_torch.search.trajectory import Trajectory
from kbmod_tpu_torch.search.trajectory_list import (
    extract_all_trajectory_x,
    extract_all_trajectory_y,
    extract_all_trajectory_vx,
    extract_all_trajectory_vy,
)


def predict_pixel_locations(times, x0, vx, centered=True, as_int=True):
    """Predicted pixel locations: (R, T) matrix of x0 + vx*t (+0.5 when
    centered), truncated with astype(int) when as_int (matching the
    reference's int-cast semantics, trajectory_utils.py:69-72)."""
    times = np.asarray(times)
    x0 = np.asarray(x0)
    vx = np.asarray(vx)
    if len(x0) != len(vx):
        raise ValueError(f"x0 and vx must be same size. Found {len(x0)} vs {len(vx)}")
    pos = vx[:, np.newaxis] * times[np.newaxis, :] + x0[:, np.newaxis]
    if centered:
        pos = pos + 0.5
    if as_int:
        pos = pos.astype(int)
    return pos


def make_trajectory_from_ra_dec(ra, dec, v_ra, v_dec, wcs):
    """Trajectory from sky position + sky velocity (deg, deg/day) using a
    linear approximation through the WCS."""
    x0, y0 = wcs.world_to_pixel_values(ra, dec)
    x1, y1 = wcs.world_to_pixel_values(ra + v_ra, dec + v_dec)
    return Trajectory(x=int(x0), y=int(y0), vx=float(x1 - x0), vy=float(y1 - y0))


def trajectory_predict_skypos(trj, wcs, times):
    """Predicted (RA, Dec) of a trajectory at given MJDs (linear pixel
    motion through the WCS). Returns what ``wcs.pixel_to_world`` returns."""
    dt = np.asarray(times)
    zeroed_dt = dt - dt[0]
    x_vals = trj.x + trj.vx * zeroed_dt
    y_vals = trj.y + trj.vy * zeroed_dt
    return wcs.pixel_to_world(x_vals, y_vals)


def fit_trajectory_from_pixels(x_vals, y_vals, times, centered=True):
    """Least-squares linear trajectory from pixel observations, with the
    starting pixel rounded to an integer."""
    num_pts = len(times)
    x_vals = np.asarray(x_vals, dtype=float)
    y_vals = np.asarray(y_vals, dtype=float)
    times = np.asarray(times, dtype=float)
    if len(x_vals) != num_pts or len(y_vals) != num_pts:
        raise ValueError(f"Mismatched number of points x={len(x_vals)}, y={len(y_vals)}, times={num_pts}.")
    if num_pts < 2:
        raise ValueError("At least 2 points are needed to fit a linear trajectory.")
    if np.any(times[:-1] >= times[1:]):
        raise ValueError("Times are not in sorted order.")
    dt = times - times[0]

    design = np.vstack([dt, np.ones(num_pts)]).T
    shift = 0.5 if centered else 0.0
    vx, x0 = np.linalg.lstsq(design, x_vals - shift, rcond=None)[0]
    vy, y0 = np.linalg.lstsq(design, y_vals - shift, rcond=None)[0]
    return Trajectory(x=int(np.round(x0)), y=int(np.round(y0)), vx=vx, vy=vy)


def evaluate_trajectory_mse(trj, x_vals, y_vals, zeroed_times, centered=True):
    """Mean squared error of a trajectory's position predictions."""
    num_pts = len(zeroed_times)
    if len(x_vals) != num_pts or len(y_vals) != num_pts:
        raise ValueError(f"Mismatched number of points x={len(x_vals)}, y={len(y_vals)}, times={num_pts}.")
    if num_pts == 0:
        raise ValueError("At least one point is needed to compute the error.")
    zeroed_times = np.asarray(zeroed_times, dtype=float)
    shift = 0.5 if centered else 0.0
    pred_x = trj.x + trj.vx * zeroed_times + shift
    pred_y = trj.y + trj.vy * zeroed_times + shift
    return float(np.mean((np.asarray(x_vals) - pred_x) ** 2 + (np.asarray(y_vals) - pred_y) ** 2))


def _mean_path_distances(q_trj, base_px, base_py, times):
    q_px = q_trj.x + times * q_trj.vx
    q_py = q_trj.y + times * q_trj.vy
    dx = q_px[np.newaxis, :] - base_px
    dy = q_py[np.newaxis, :] - base_py
    return np.mean(np.sqrt(dx**2 + dy**2), axis=1)


def find_closest_trajectory(query, trj_list, times=[0.0]):
    """Index and mean-path distance of the closest trajectory in a list."""
    times = np.asarray(times)
    if len(times) == 0:
        raise ValueError("Empty times array.")
    base_px = predict_pixel_locations(times, extract_all_trajectory_x(trj_list),
                                      extract_all_trajectory_vx(trj_list), centered=False, as_int=False)
    base_py = predict_pixel_locations(times, extract_all_trajectory_y(trj_list),
                                      extract_all_trajectory_vy(trj_list), centered=False, as_int=False)
    dists = _mean_path_distances(query, base_px, base_py, times)
    idx = int(np.argmin(dists))
    return idx, float(dists[idx])


def find_closest_velocity(query, trj_list):
    """Index of the trajectory with the closest velocity."""
    d_vx = np.array([query.vx - trj.vx for trj in trj_list])
    d_vy = np.array([query.vy - trj.vy for trj in trj_list])
    return int(np.argmin(np.sqrt(d_vx**2 + d_vy**2)))


def trajectory_results_best_match(traj_query, results, times=[0.0]):
    """Greedy best-match of each query trajectory to a Results row by mean
    path distance. Returns (best_dist, best_match)."""
    times = np.asarray(times)
    if len(times) == 0:
        raise ValueError("Empty times array.")
    base_px = predict_pixel_locations(times, results["x"], results["vx"], centered=False, as_int=False)
    base_py = predict_pixel_locations(times, results["y"], results["vy"], centered=False, as_int=False)

    num_query = len(traj_query)
    best_dist = np.zeros(num_query)
    best_match = np.full(num_query, -1)
    for idx, q_trj in enumerate(traj_query):
        dists = _mean_path_distances(q_trj, base_px, base_py, times)
        best_match[idx] = int(np.argmin(dists))
        best_dist[idx] = dists[best_match[idx]]
    return best_dist, best_match


def match_trajectory_sets(traj_query, traj_base, threshold, times=[0.0]):
    """Optimal one-to-one matching (Hungarian) of query trajectories to base
    trajectories by mean path distance; -1 for unmatched queries beyond
    ``threshold``."""
    from scipy.optimize import linear_sum_assignment

    times = np.asarray(times)
    if len(times) == 0:
        raise ValueError("Empty times array.")
    if threshold <= 0.0:
        raise ValueError(f"Threshold must be greater than zero: {threshold}")

    base_px = predict_pixel_locations(times, extract_all_trajectory_x(traj_base),
                                      extract_all_trajectory_vx(traj_base), centered=False, as_int=False)
    base_py = predict_pixel_locations(times, extract_all_trajectory_y(traj_base),
                                      extract_all_trajectory_vy(traj_base), centered=False, as_int=False)

    num_query = len(traj_query)
    dists = np.zeros((num_query, len(traj_base)))
    for q_idx, q_trj in enumerate(traj_query):
        dists[q_idx, :] = _mean_path_distances(q_trj, base_px, base_py, times)

    row_inds, col_inds = linear_sum_assignment(dists)
    results = np.full(num_query, -1)
    for row, col in zip(row_inds, col_inds):
        if dists[row, col] < threshold:
            results[row] = col
    return results
