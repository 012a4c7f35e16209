"""Plotting helpers for results, stamps, and light curves.

Behavior-compatible with the reference's kbmod.analysis.plotting
(src/kbmod/analysis/plotting.py): stamp grids, light curves, image
footprints, and per-result summary figures. The JAX package's module with
its imports re-pointed (the port's host ``geom.wcs.WCS``).
"""

import numpy as np

__all__ = [
    "plot_image",
    "plot_multiple_images",
    "plot_time_series",
    "plot_result_row",
    "plot_result_row_summary",
    "plot_image_bounds",
]


def _get_plt():
    import matplotlib.pyplot as plt

    return plt


def plot_image(image, ax=None, figure=None, norm=True, title=None, show_counts=False, cmap="gray"):
    """Plot a single image (stamp or full frame) with optional percentile
    normalization."""
    plt = _get_plt()
    if ax is None:
        figure = figure or plt.figure()
        ax = figure.add_subplot(111)
    image = np.asanyarray(image)
    if norm and np.any(np.isfinite(image)):
        vmin, vmax = np.nanpercentile(image, [0.5, 99.5])
    else:
        vmin = vmax = None
    im = ax.imshow(image, origin="lower", cmap=cmap, vmin=vmin, vmax=vmax)
    if title:
        ax.set_title(title)
    if show_counts:
        plt.colorbar(im, ax=ax)
    return ax


def plot_multiple_images(images, labels=None, columns=3, norm=True, figure=None, cmap="gray"):
    """Plot a grid of images (e.g. all stamps for a result)."""
    plt = _get_plt()
    images = [np.asanyarray(img) for img in images]
    num = len(images)
    rows = int(np.ceil(num / columns))
    figure = figure or plt.figure(figsize=(3 * columns, 3 * rows))
    for idx, img in enumerate(images):
        ax = figure.add_subplot(rows, columns, idx + 1)
        label = labels[idx] if labels is not None else f"{idx}"
        plot_image(img, ax=ax, norm=norm, title=label, cmap=cmap)
        ax.set_xticks([])
        ax.set_yticks([])
    if hasattr(figure, "tight_layout"):  # SubFigures have no tight_layout
        figure.tight_layout()
    return figure


def plot_time_series(values, times=None, indices=None, ax=None, figure=None, title=None):
    """Plot a light curve (psi/phi/likelihood series), marking invalid
    points."""
    plt = _get_plt()
    if ax is None:
        figure = figure or plt.figure()
        ax = figure.add_subplot(111)
    values = np.asanyarray(values, dtype=float)
    x = np.asanyarray(times, dtype=float) if times is not None else np.arange(len(values))
    if indices is None:
        indices = np.isfinite(values)
    indices = np.asanyarray(indices, dtype=bool)
    ax.plot(x, values, color="0.7", linewidth=1)
    ax.plot(x[indices], values[indices], "b.", label="valid")
    if np.any(~indices):
        ax.plot(x[~indices], values[~indices], "rx", label="invalid")
        ax.legend()
    if title:
        ax.set_title(title)
    return ax


def plot_image_bounds(wcs_list, shapes, ax=None, figure=None, labels=None):
    """Plot the sky footprints of a set of images from their WCSes."""
    plt = _get_plt()
    if ax is None:
        figure = figure or plt.figure()
        ax = figure.add_subplot(111)
    for i, (wcs, shape) in enumerate(zip(wcs_list, shapes)):
        if wcs is None:
            continue
        h, w = shape
        xs = [0, w - 1, w - 1, 0, 0]
        ys = [0, 0, h - 1, h - 1, 0]
        ra, dec = wcs.pixel_to_world_values(xs, ys)
        label = labels[i] if labels is not None else None
        ax.plot(ra, dec, label=label)
    ax.set_xlabel("RA (deg)")
    ax.set_ylabel("Dec (deg)")
    if labels is not None:
        ax.legend()
    return ax


def _row_lightcurve(row):
    """(lc, valid): the psi/phi flux curve with the validity mask the
    reference uses (phi != 0, finite, obs_valid; plotting.py:555-565)."""
    psi = np.asanyarray(row["psi_curve"], dtype=float)
    phi = np.asanyarray(row["phi_curve"], dtype=float)
    valid = (phi != 0) & np.isfinite(psi) & np.isfinite(phi)
    if "obs_valid" in row:
        valid = valid & np.asanyarray(row["obs_valid"], dtype=bool)
    lc = np.zeros(psi.shape)
    lc[valid] = psi[valid] / phi[valid]
    return lc, valid


def plot_result_row(row, times=None, coadd_col="stamp", figure=None):
    """One result row: coadded stamp + light curve on top, the per-time
    stamp gallery on the bottom (reference plotting.py:527-580)."""
    plt = _get_plt()
    figure = figure or plt.figure(layout="constrained")
    fig_top, fig_bot = figure.subfigures(2, 1)

    ax_stamp, ax_lc = fig_top.subplots(1, 2)
    if coadd_col in row and row[coadd_col] is not None:
        plot_image(row[coadd_col], ax=ax_stamp, figure=fig_top, norm=True, title="Coadded Stamp")
    else:
        ax_stamp.text(0.5, 0.5, "No Stamp", ha="center")

    if "psi_curve" in row and "phi_curve" in row:
        lc, valid = _row_lightcurve(row)
        plot_time_series(lc, times, indices=valid, ax=ax_lc, figure=fig_top, title="Light curve")
    else:
        ax_lc.text(0.5, 0.5, "No Lightcurve", ha="center")

    if "all_stamps" in row and row["all_stamps"] is not None:
        labels = [f"T={t}" for t in times] if times is not None else None
        plot_multiple_images(row["all_stamps"], figure=fig_bot, columns=5, labels=labels)
    else:
        ax = fig_bot.add_axes([0, 0, 1, 1])
        ax.text(0.5, 0.5, "No Individual Stamps", ha="center")
    return figure


def plot_result_row_summary(row, idx=None, times=None, figure=None):
    """Result-row summary: light curve + its histogram on top, the four
    coadd variants on the bottom (reference plotting.py:615-655).

    Accepts a table row directly (the reference signature) or a Results
    object plus ``idx``.
    """
    plt = _get_plt()
    if idx is not None and hasattr(row, "table"):
        row = row.table[int(idx)]
    figure = figure or plt.figure(layout="constrained")
    fig_top, fig_bot = figure.subfigures(2, 1)

    ax_curves = fig_top.subplots(1, 2)
    if "psi_curve" in row and "phi_curve" in row:
        lc, valid = _row_lightcurve(row)
        plot_time_series(lc, times, indices=valid, ax=ax_curves[0], figure=fig_top, title="Psi/Phi")
        counts, bins = compute_lightcurve_histogram(row)
        ax_curves[1].stairs(counts, bins)
        ax_curves[1].set_title("Light curve histogram")

    ax_stamps = fig_bot.subplots(1, 4)
    for col, name in enumerate(["coadd_sum", "coadd_mean", "coadd_median", "coadd_weighted"]):
        if name in row and row[name] is not None:
            plot_image(row[name], ax=ax_stamps[col], figure=fig_bot, norm=True,
                       title=name, show_counts=False)
        else:
            ax_stamps[col].text(0.5, 0.5, f"No {name}", ha="center")
    return figure


# --- field / footprint helpers (reference plotting.py:37-299) ---

def iter_over_obj(objects):
    """Iterate over unique objects (grouped by ``Name``, epoch-sorted)."""
    names = sorted(set(np.asarray(objects["Name"]).tolist()))
    name_col = np.asarray(objects["Name"])
    for name in names:
        obj = objects[name_col == name]
        order = np.argsort(np.asarray(obj["epoch"]))
        yield obj[order] if hasattr(obj, "__getitem__") else obj


def transform_rect(points):
    """Top-left corner, width, height (negative), and rotation angle of a
    rectangle given as 4 clockwise corner points."""
    p = np.asarray(points, dtype=float)
    width = float(np.hypot(*(p[1] - p[0])))
    height = float(np.hypot(*(p[2] - p[1])))
    angle = float(np.arctan2(p[0][1] - p[-1][1], p[0][0] - p[-1][0]))
    return tuple(p[0]), width, -height, angle


def plot_field(ax, center, radius):
    """Mark a circular field of view at ``center`` with ``radius``."""
    plt = _get_plt()
    ax.scatter(*center, color="black", label="Pointing area")
    ax.add_artist(plt.Circle(tuple(center), radius, fill=False, color="black"))
    return ax


def plot_bbox(ax, bbox):
    """Draw one rectangle given 4 clockwise corner points."""
    plt = _get_plt()
    xy, width, height, angle = transform_rect(bbox)
    ax.add_artist(
        plt.Rectangle(xy, width, height, angle=np.degrees(angle), fill=None, color="black")
    )
    return ax


def plot_bboxes(ax, bboxes):
    for bbox in bboxes:
        plot_bbox(ax, bbox)
    return ax


def _wcs_footprint(wcs, shape=None):
    """Corner (ra, dec) positions of a WCS, clockwise."""
    if shape is None:
        h = int(2 * wcs.crpix[1])
        w = int(2 * wcs.crpix[0])
    else:
        h, w = shape
    xs = np.array([0.0, w - 1.0, w - 1.0, 0.0])
    ys = np.array([0.0, 0.0, h - 1.0, h - 1.0])
    ra, dec = wcs.pixel_to_world_values(xs, ys)
    return np.stack([np.asarray(ra), np.asarray(dec)], axis=1)


def plot_footprint(ax, wcs, shape=None):
    """Draw the sky footprint of a WCS."""
    return plot_bbox(ax, _wcs_footprint(wcs, shape))


def plot_footprints(ax, wcs_list, shapes=None):
    for i, wcs in enumerate(wcs_list):
        plot_footprint(ax, wcs, None if shapes is None else shapes[i])
    return ax


def plot_all_objs(ax, objects, count=-1, show_field=False, center=None, radius=1.1, lw=0.9, ms=1):
    """Plot the (RA, DEC) tracks of ephemeris objects (columns Name/RA/DEC)."""
    if show_field:
        plot_field(ax, center, radius)
    if count < 0:
        return ax
    for i, obj in enumerate(iter_over_obj(objects)):
        if count > 0 and i == count:
            break
        ax.plot(obj["RA"], obj["DEC"], label=obj["Name"][0], marker="o", lw=lw, ms=ms)
    return ax


def plot_focal_plane(ax, hdulist, showExtName=True):
    """Draw the footprints of every HDU in an HDUList that carries a WCS."""
    from kbmod_tpu_torch.geom.wcs import WCS as _WCS

    for hdu in hdulist:
        header = getattr(hdu, "header", {}) or {}
        if "CRVAL1" not in header:
            continue
        try:
            wcs = _WCS.from_header(header)
        except Exception:
            continue
        plot_footprint(ax, wcs)
        if showExtName and header.get("EXTNAME"):
            ra0, dec0 = wcs.pixel_to_world_values(0.0, 0.0)
            ax.text(float(ra0), float(dec0), header["EXTNAME"], clip_on=True)
    return ax


def plot_cutouts(axes, cutouts, remove_extra_axes=True):
    """Plot a collection of cutout images onto a grid of axes with center
    crosshairs; extra axes are removed."""
    axs = np.asarray(axes).ravel()
    if len(axs) < len(cutouts):
        raise ValueError(f"N axes ({len(axs)}) doesn't match N plots ({len(cutouts)}).")
    for ax, cutout in zip(axs, cutouts):
        img = np.asarray(getattr(cutout, "data", cutout), dtype=float)
        plot_image(img, ax=ax)
        ax.set_aspect("equal")
        ax.axvline((img.shape[1] - 1) / 2, c="red", lw=0.25)
        ax.axhline((img.shape[0] - 1) / 2, c="red", lw=0.25)
    if remove_extra_axes:
        for ax in axs[len(cutouts):]:
            ax.remove()
    return axes


def compute_lightcurve_histogram(row, min_val=0.0, max_val=1000.0, bins=20):
    """Histogram of the clamped psi/phi lightcurve of one result row."""
    psi = np.asarray(row["psi_curve"], dtype=float)
    phi = np.asarray(row["phi_curve"], dtype=float)
    valid = (phi != 0) & np.isfinite(psi) & np.isfinite(phi)
    lc = np.clip(psi[valid] / phi[valid], min_val, max_val)
    return np.histogram(lc, bins=bins)


def plot_search_trajectories(gen, figure=None):
    """Scatter the (vx, vy) grid produced by a TrajectoryGenerator."""
    plt = _get_plt()
    if figure is None:
        figure = plt.figure()
    ax = figure.add_subplot()
    tbl = gen.to_table()
    ax.plot(tbl["vx"], tbl["vy"], color="black", marker=".", markersize=2, linewidth=0)
    ax.set_xlabel("vx (pixels / day)")
    ax.set_ylabel("vy (pixels / day)")
    return figure, ax


def plot_ic_polygon(ax, ic, idx, reflex_dist=0.0, lw=1, color=None, alpha=None):
    """Plot the footprint polygon of one ImageCollection row (optionally a
    reflex-corrected variant: columns ra_{dist}/dec_{dist})."""
    suffix = f"_{reflex_dist}" if reflex_dist else ""
    # Prefer explicit corner columns when present.
    corner_cols = [f"ra_tl{suffix}", f"ra_tr{suffix}", f"ra_br{suffix}", f"ra_bl{suffix}"]
    if all(c in ic.columns for c in corner_cols):
        ras = [float(ic[c][idx]) for c in corner_cols]
        decs = [float(ic[c.replace("ra", "dec")][idx]) for c in corner_cols]
    else:
        wcs = ic.get_standardizer(idx)["std"].standardizeWCS()[0]
        pts = _wcs_footprint(wcs, (int(ic["height"][idx]), int(ic["width"][idx]))
                             if "height" in ic.columns else None)
        ras = list(pts[:, 0])
        decs = list(pts[:, 1])
    ras.append(ras[0])
    decs.append(decs[0])
    ax.plot(ras, decs, lw=lw, color=color, alpha=alpha)
    return ax


def plot_ic_image_bounds(ic, patch=None, reflex_distances=(0.0,), lw=1, alpha=None):
    """Plot every ImageCollection footprint, one color per visit, for each
    reflex-corrected distance; optionally overlay a region-search Patch."""
    import itertools

    plt = _get_plt()
    fig = plt.figure(figsize=[8, 8])
    ax = fig.add_subplot()
    colors = itertools.cycle(plt.rcParams["axes.prop_cycle"].by_key()["color"])
    visits = np.asarray(ic["visit"]) if "visit" in ic.columns else np.arange(len(ic))
    for visit in sorted(set(visits.tolist())):
        color = next(colors)
        for idx in np.nonzero(visits == visit)[0]:
            for dist in reflex_distances:
                plot_ic_polygon(ax, ic, int(idx), reflex_dist=dist, lw=lw, color=color, alpha=alpha)
    if patch is not None:
        corners = list(patch.corners) + [patch.corners[0]]
        ax.plot([c[0] for c in corners], [c[1] for c in corners], color="black", lw=2)
    ax.set_xlabel("RA (deg)")
    ax.set_ylabel("Dec (deg)")
    return fig


def plot_wcs_on_sky(wcs_list, labels=None, figure=None):
    """Footprints of a list of WCSes on shared sky axes."""
    plt = _get_plt()
    figure = figure or plt.figure()
    ax = figure.add_subplot()
    for i, wcs in enumerate(wcs_list):
        pts = _wcs_footprint(wcs)
        closed = np.vstack([pts, pts[:1]])
        ax.plot(closed[:, 0], closed[:, 1],
                label=None if labels is None else labels[i])
    if labels is not None:
        ax.legend()
    ax.set_xlabel("RA (deg)")
    ax.set_ylabel("Dec (deg)")
    return figure, ax
