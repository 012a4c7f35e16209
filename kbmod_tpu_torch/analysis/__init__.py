"""Analysis and visualization helpers (matplotlib-based).

Reference: src/kbmod/analysis/ (plotting.py, visualizer.py,
analyze_fakes.py, results_rater.py). The port's copies of the JAX package's
modules, host numpy with matplotlib imported inside functions; only
``Visualizer`` reaches the card (its stamps).
"""

from kbmod_tpu_torch.analysis.results_rater import ResultsRater, extract_results_row_scalars

__all__ = ["ResultsRater", "extract_results_row_scalars"]
