"""Clustering/deduplication of result trajectories.

Port of the JAX package's filters/clustering_filters.py (API-compatible with
the reference's kbmod.filters.clustering_filters): DBSCAN on position/velocity
spaces keeping the best-likelihood member per cluster, a KD-tree
nearest-neighbor sweep, and the discrete cluster grid; dispatched through
``apply_clustering`` by cluster_type.

The JAX package runs scikit-learn's ``DBSCAN(eps, min_samples=1)``. With
``min_samples=1`` every point is a core point, so its clusters are the
connected components of the graph that joins points at distance <= eps;
the port builds them with scipy (a KD-tree's pairs within eps, then
``connected_components``) and needs no scikit-learn.
"""

import logging

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components
from scipy.spatial import cKDTree

from kbmod_tpu_torch.filters.clustering_grid import TrajectoryClusterGrid, grid_keep_indices
from kbmod_tpu_torch.utils.debug_timer import DebugTimer

logger = logging.getLogger(__name__)


def dbscan_min1_labels(data, eps):
    """Cluster labels of ``DBSCAN(eps, min_samples=1)`` on the (N, D) rows
    of ``data``: the connected components of the graph whose edges join rows
    at Euclidean distance <= eps (computed in float64), numbered as
    scikit-learn numbers them, in the order of each cluster's smallest
    member index."""
    data = np.asarray(data, dtype=np.float64)
    n = len(data)
    pairs = cKDTree(data).query_pairs(eps, output_type="ndarray")
    graph = coo_matrix((np.ones(len(pairs), dtype=np.int8), (pairs[:, 0], pairs[:, 1])), shape=(n, n))
    # A breadth-first labelling from row 0 upward: component labels follow
    # their smallest members.
    _, labels = connected_components(graph, directed=False)
    return labels


class DBSCANFilter:
    """DBSCAN clustering (min_samples=1) keeping one representative (max
    likelihood) per cluster."""

    def __init__(self, cluster_eps, **kwargs):
        self.cluster_eps = cluster_eps
        self.cluster_type = ""

    def get_filter_name(self):
        return f"DBSCAN_{self.cluster_type} eps={self.cluster_eps}"

    def _build_clustering_data(self, result_data):
        """The N x D matrix to cluster."""
        raise NotImplementedError()

    def keep_indices(self, result_data):
        """Indices of rows to keep (best lh per cluster)."""
        labels = dbscan_min1_labels(self._build_clustering_data(result_data), self.cluster_eps)
        # The first index of the highest likelihood in each cluster, the
        # clusters in label order: one stable sort by (label, -lh).
        lh = np.asarray(result_data["likelihood"], dtype=np.float64)
        order = np.lexsort((-lh, labels))
        first = np.ones(len(order), dtype=bool)
        first[1:] = labels[order[1:]] != labels[order[:-1]]
        return list(order[first])


class ClusterPredictionFilter(DBSCANFilter):
    """Cluster on predicted positions at chosen times."""

    def __init__(self, cluster_eps, pred_times=[0.0], **kwargs):
        super().__init__(cluster_eps, **kwargs)
        if len(pred_times) == 0:
            raise ValueError("No prediction times given.")
        self.times = np.array(pred_times, dtype=np.float32)
        self.cluster_type = f"position t={self.times}"

    def _build_clustering_data(self, result_data):
        x = np.asarray(result_data["x"], dtype=np.float32)[:, None]
        vx = np.asarray(result_data["vx"], dtype=np.float32)[:, None]
        y = np.asarray(result_data["y"], dtype=np.float32)[:, None]
        vy = np.asarray(result_data["vy"], dtype=np.float32)[:, None]
        pred_x = x + vx * self.times[None, :]
        pred_y = y + vy * self.times[None, :]
        return np.hstack([pred_x, pred_y])


class ClusterPosVelFilter(DBSCANFilter):
    """Cluster on (x, y, scaled vx, scaled vy)."""

    def __init__(self, cluster_eps, cluster_v_scale=1.0, **kwargs):
        super().__init__(cluster_eps, **kwargs)
        if cluster_v_scale < 0.0:
            raise ValueError("cluster_v_scale cannot be negative.")
        self.cluster_v_scale = cluster_v_scale
        self.cluster_type = "all"

    def _build_clustering_data(self, result_data):
        data = np.empty((len(result_data), 4), dtype=np.float32)
        data[:, 0] = np.asarray(result_data["x"], dtype=np.float32)
        data[:, 1] = np.asarray(result_data["y"], dtype=np.float32)
        data[:, 2] = np.asarray(result_data["vx"], dtype=np.float32) * self.cluster_v_scale
        data[:, 3] = np.asarray(result_data["vy"], dtype=np.float32) * self.cluster_v_scale
        return data


class NNSweepFilter:
    """Keep only results that are the likelihood maximum within
    ``cluster_eps`` of their predicted positions (KD-tree sweep)."""

    def __init__(self, cluster_eps, pred_times, batch_size=1_000):
        if cluster_eps <= 0.0:
            raise ValueError("Threshold must be > 0.0.")
        self.thresh = cluster_eps
        self.times = np.asarray(pred_times, dtype=np.float32)
        if len(self.times) == 0:
            raise ValueError("Empty time array provided.")
        if batch_size <= 0:
            raise ValueError("batch_size must be > 0.")
        self.batch_size = batch_size

    def get_filter_name(self):
        return f"NNFilter times={self.times} eps={self.thresh}"

    def _build_clustering_data(self, result_data):
        x = np.asarray(result_data["x"], dtype=np.float32)[:, None]
        vx = np.asarray(result_data["vx"], dtype=np.float32)[:, None]
        y = np.asarray(result_data["y"], dtype=np.float32)[:, None]
        vy = np.asarray(result_data["vy"], dtype=np.float32)[:, None]
        return np.hstack([x + vx * self.times[None, :], y + vy * self.times[None, :]])

    def keep_indices(self, result_data):
        from scipy.spatial import KDTree

        timer = DebugTimer("NNSweepFilter building data", logger)
        cart_data = self._build_clustering_data(result_data)
        kd_tree = KDTree(cart_data)
        timer.stop()

        num_pts = len(result_data)
        lh_data = np.asarray(result_data["likelihood"])

        num_workers = -1 if self.batch_size > 1 else 1
        can_skip = np.full(num_pts, False)
        keep_vals = []
        batch_start = 0
        while batch_start < num_pts:
            batch_end = min(num_pts, batch_start + self.batch_size)
            batch_inds = np.asarray([i for i in range(batch_start, batch_end) if not can_skip[i]])
            if len(batch_inds) == 0:
                batch_start = batch_end
                continue
            batch_matches = kd_tree.query_ball_point(cart_data[batch_inds, :], self.thresh, workers=num_workers)
            for batch_idx, total_idx in enumerate(batch_inds):
                if not can_skip[total_idx]:
                    matches = np.asarray(batch_matches[batch_idx])
                    if lh_data[total_idx] >= np.max(lh_data[matches]):
                        keep_vals.append(total_idx)
                        # This neighborhood's maximum is found; skip the rest.
                        can_skip[matches] = True
            batch_start = batch_end
        return keep_vals


class ClusterGridFilter:
    """Discrete-grid clustering: best trajectory per (start, end) bin."""

    def __init__(self, cluster_eps, pred_times):
        self.bin_width = np.ceil(cluster_eps)
        if self.bin_width <= 0:
            raise ValueError("Bin width must be > 0.0.")
        self.times = np.asarray(pred_times)
        if len(self.times) == 0:
            self.times = np.array([0.0])
        self.max_dt = np.max(self.times) - np.min(self.times)
        self.cluster_grid = TrajectoryClusterGrid(bin_width=self.bin_width, max_time=self.max_dt)

    def get_filter_name(self):
        return f"ClusterGridFilter bin_width{self.bin_width}, max_dt={self.max_dt}"

    def keep_indices(self, result_data):
        # Vectorized best-per-bin selection (clustering_grid.grid_keep_indices).
        return list(
            grid_keep_indices(
                np.asarray(result_data["x"]),
                np.asarray(result_data["y"]),
                np.asarray(result_data["vx"]),
                np.asarray(result_data["vy"]),
                np.asarray(result_data["likelihood"]),
                self.bin_width,
                self.max_dt,
            )
        )


def apply_clustering(result_data, cluster_params):
    """Cluster results by trajectory similarity and keep representatives.

    cluster_params must include cluster_type, cluster_eps, times, and
    optionally cluster_v_scale. Modifies ``result_data`` in place.
    """
    if "cluster_type" not in cluster_params:
        raise KeyError("Missing cluster_type parameter")
    cluster_type = cluster_params["cluster_type"]

    if len(result_data) == 0:
        logger.info("Clustering : skipping, no results.")
        return

    if "times" not in cluster_params:
        raise KeyError("Missing times parameter in the clustering parameters.")
    all_times = np.sort(cluster_params["times"])
    zeroed_times = np.asarray(all_times) - all_times[0]

    kwargs = {k: v for k, v in cluster_params.items() if k not in ("cluster_type", "times")}
    if cluster_type in ("all", "pos_vel"):
        filt = ClusterPosVelFilter(**kwargs)
    elif cluster_type in ("position", "start_position"):
        kwargs["pred_times"] = [0.0]
        filt = ClusterPredictionFilter(**kwargs)
    elif cluster_type == "mid_position":
        kwargs["pred_times"] = [np.median(zeroed_times)]
        filt = ClusterPredictionFilter(**kwargs)
    elif cluster_type == "start_end_position":
        kwargs["pred_times"] = [0.0, zeroed_times[-1]]
        filt = ClusterPredictionFilter(**kwargs)
    elif cluster_type == "nn_start_end":
        filt = NNSweepFilter(cluster_params["cluster_eps"], [0.0, zeroed_times[-1]])
    elif cluster_type == "nn_start":
        filt = NNSweepFilter(cluster_params["cluster_eps"], [0.0])
    elif cluster_type == "grid_start_end":
        filt = ClusterGridFilter(cluster_params["cluster_eps"], [0.0, zeroed_times[-1]])
    elif cluster_type == "grid_start":
        filt = ClusterGridFilter(cluster_params["cluster_eps"], [0.0])
    else:
        raise ValueError(f"Unknown clustering type: {cluster_type}")
    logger.info(f"Clustering {len(result_data)} results using {filt.get_filter_name()}")

    indices_to_keep = filt.keep_indices(result_data)
    result_data.filter_rows(indices_to_keep, filt.get_filter_name())
