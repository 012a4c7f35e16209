"""SNS (Solar-system New-object Search) filters: stamp peak-offset cuts and
greedy SNR-ordered predictive line clustering.

Port of the JAX package's filters/sns_filters.py (host numpy),
behavior-compatible with the reference's kbmod.filters.sns_filters
(src/kbmod/filters/sns_filters.py), which implements W. Fraser's filtering.
"""

import numpy as np


def peak_offset_filter(res, peak_offset_max=6):
    """Drop rows whose coadd_mean peak is farther than ``peak_offset_max``
    pixels from the stamp center."""
    if "coadd_mean" not in res.colnames:
        raise RuntimeError("coadd_mean column not present in results")

    stamps = np.asarray(res["coadd_mean"])
    N, a, b = stamps.shape
    flat = stamps.reshape(N, a * b)
    args = np.argmax(flat, axis=1)
    Y, X = np.divmod(args, b)
    radial_d = np.hypot(X - b / 2, Y - a / 2)
    keep = np.where(radial_d < peak_offset_max)[0]
    res.table = res.table[keep]


def predictive_line_cluster(res, dmjds, dist_lim=4.0, min_samp=2, init_select_proc_distance=60):
    """Greedy SNR-ordered clustering on line consistency in (x, y, vx, vy).

    Repeatedly takes the highest-SNR remaining result, gathers spatial
    neighbors, and groups those whose differential-rate-shifted predicted
    centroids fall within ``dist_lim`` of the line through the best
    detection; keeps the cluster seed when the cluster reaches ``min_samp``
    members. Modifies ``res`` in place to the kept seeds.
    """
    snr = np.asarray(res["psi_curve"]) / np.sqrt(np.asarray(res["phi_curve"]))
    max_snr = np.nanmax(snr, axis=1)

    x_col = np.asarray(res["x"], dtype=np.float64)
    y_col = np.asarray(res["y"], dtype=np.float64)
    vx_col = np.asarray(res["vx"], dtype=np.float64)
    vy_col = np.asarray(res["vy"], dtype=np.float64)
    dt = np.asarray(dmjds, dtype=np.float64)

    proc_inds = np.arange(len(x_col))
    clust_inds = []

    while len(max_snr) > 0:
        arg_max = int(np.argmax(max_snr))
        x_o, y_o = x_col[arg_max], y_col[arg_max]
        rx_o, ry_o = vx_col[arg_max], vy_col[arg_max]

        # Pre-select a box then a circle of spatial neighbors (memory guard).
        box = np.where(
            (x_col > x_o - init_select_proc_distance)
            & (x_col < x_o + init_select_proc_distance)
            & (y_col > y_o - init_select_proc_distance)
            & (y_col < y_o + init_select_proc_distance)
        )[0]
        circle = np.where((x_col[box] - x_o) ** 2 + (y_col[box] - y_o) ** 2 < init_select_proc_distance**2)[0]
        w = box[circle]

        # Distance of each neighbor's position from the line through the
        # best detection shifted by the differential rate.
        drx = vx_col[w] - rx_o
        dry = vy_col[w] - ry_o
        x_n = x_o - drx * dt[-1]
        y_n = y_o - dry * dt[-1]
        dx = x_n - x_o
        dy = y_n - y_o
        top = np.abs(dy * x_col[w] - dx * y_col[w] + x_n * y_o - y_n * x_o)
        bottom = np.sqrt(dx * dx + dy * dy)
        bottom[bottom == 0.0] = 1e-12
        dist = top / bottom

        clust = np.where((dist < dist_lim) | np.isnan(dist))[0]
        if len(clust) >= min_samp:
            clust_inds.append(int(proc_inds[arg_max]))

        mask = np.ones(len(x_col), dtype=bool)
        mask[w[clust]] = False
        x_col = x_col[mask]
        y_col = y_col[mask]
        vx_col = vx_col[mask]
        vy_col = vy_col[mask]
        proc_inds = proc_inds[mask]
        max_snr = max_snr[mask]

    clust_inds.sort()
    res.table = res.table[clust_inds]
