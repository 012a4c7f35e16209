"""SearchConfiguration: typed, validated, serializable search parameters.

Port of the JAX package's configuration.py (itself API- and
default-compatible with the reference's kbmod.configuration): the same
parameter names, defaults, sections and validators, with dict, YAML and file
round-trips. PyYAML is imported only by the YAML forms (``from_yaml``,
``to_yaml``, the file and table forms), which raise an ImportError naming it
where it is missing; the dict forms need nothing. The FITS-HDU forms wait
for the port's FITS IO and raise NotImplementedError.
"""

import copy
import math
from pathlib import Path

from kbmod_tpu_torch.utils.logging_utils import Logging

logger = Logging.getLogger(__name__)


def _yaml():
    """The PyYAML module, or an ImportError that names it."""
    try:
        import yaml
    except ImportError as err:
        raise ImportError(
            "SearchConfiguration's YAML forms need PyYAML (the 'yaml' module), which is not installed; "
            "use from_dict/to_dict instead"
        ) from err
    return yaml


_FITS_DEFERRED = "the FITS-HDU forms of SearchConfiguration wait for the port's FITS IO"


class _ParamInfo:
    """Metadata for one configuration parameter."""

    def __init__(self, name, default_value, description="", section="other", validate_func=None, required=False):
        self.name = name
        self.default_value = default_value
        self.description = description
        self.section = section
        self.validate_func = validate_func
        self.required = required

    def __str__(self):
        return f"{self.name}: {self.description} (Default: {self.default_value})"

    def validate(self, value):
        if self.required and value is None:
            return False
        if self.validate_func is not None:
            return self.validate_func(value)
        return True


def _is_num(x):
    return isinstance(x, (int, float))


# All supported parameters: same names/defaults/sections as the reference
# (configuration.py:73-400).
_SUPPORTED_PARAMS = [
    _ParamInfo("clip_negative", False,
               "If True remove all negative values prior to sigmaG computing the percentiles.",
               "filtering", lambda x: isinstance(x, bool)),
    _ParamInfo("cluster_eps", 20.0, "The epsilon parameter for clustering (in pixels).",
               "clustering", lambda x: _is_num(x) and x >= 0),
    _ParamInfo("cluster_type", "all", "The type of clustering algorithm to use (if do_clustering = True).",
               "clustering", lambda x: isinstance(x, str)),
    _ParamInfo("cluster_v_scale", 1.0,
               "The weight of differences in velocity relative to differences in distances during clustering.",
               "clustering", lambda x: _is_num(x) and x >= 0),
    _ParamInfo("color_scale", None,
               "A dictionary mapping filter names to a color scale factor to use for those images.",
               "core", lambda x: x is None or isinstance(x, (dict, int, float))),
    _ParamInfo("cnn_filter", False, "If True, applies a CNN filter to the stamps.",
               "filtering", lambda x: isinstance(x, bool)),
    _ParamInfo("cnn_model", None, "The path to the CNN model file to use for filtering.",
               "filtering", lambda x: isinstance(x, str) or x is None),
    _ParamInfo("cnn_coadd_type", "mean",
               "The type of coadd to use for CNN filtering ('mean', 'median', or 'sum').",
               "filtering", lambda x: x in ["mean", "median", "sum"]),
    _ParamInfo("cnn_stamp_radius", 49,
               "The radius (in pixels) of the stamp to use for CNN filtering if cnn_filter is True.",
               "filtering", lambda x: isinstance(x, int) and x > 0),
    _ParamInfo("cnn_model_type", "resnet18",
               "The type of CNN model to use ('resnet18', 'resnet34', etc.) if cnn_filter is True.",
               "filtering", lambda x: isinstance(x, str)),
    _ParamInfo("coadds", [], "The list of coadd images to compute ('mean', 'median', 'sum', 'weighted').",
               "stamps",
               lambda x: isinstance(x, list) and all(i in ["mean", "median", "sum", "weighted"] for i in x)),
    _ParamInfo("compute_ra_dec", True, "If True, compute RA and Dec for each result.",
               "output", lambda x: isinstance(x, bool)),
    _ParamInfo("cpu_only", False,
               "If True, only use the CPU for processing, even if a GPU is available.",
               "other", lambda x: isinstance(x, bool)),
    _ParamInfo("debug", False, "Run with debug logging enabled.", "other", lambda x: isinstance(x, bool)),
    _ParamInfo("do_clustering", True, "If true, perform clustering on the results.",
               "clustering", lambda x: isinstance(x, bool)),
    _ParamInfo("drop_columns", [], "List of result table columns to drop.",
               "output", lambda x: isinstance(x, list) and all(isinstance(i, str) for i in x)),
    _ParamInfo("encode_num_bytes", -1,
               "Number of bytes to use for encoding pixel values on GPU. -1 means no encoding.",
               "core", lambda x: x in {-1, 1, 2, 4}),
    _ParamInfo("generator_config",
               {
                   "name": "EclipticCenteredSearch",
                   "velocities": [92.0, 526.0, 257],
                   "angles": [-math.pi / 15, math.pi / 15, 129],
                   "angle_units": "radian",
                   "velocity_units": "pix / d",
                   "given_ecliptic": None,
               },
               "Configuration dictionary for the trajectory generator.",
               "core", lambda x: isinstance(x, dict) and "name" in x),
    _ParamInfo("generate_psi_phi", True,
               "If True, computes the psi and phi curves and saves them with the results.",
               "filtering", lambda x: isinstance(x, bool)),
    _ParamInfo("gpu_filter", False, "If True, performs initial sigmaG filtering on GPU.",
               "filtering", lambda x: isinstance(x, bool)),
    _ParamInfo("lh_level", 10.0, "The log-likelihood level above which results are kept.",
               "filtering", _is_num),
    _ParamInfo("max_masked_pixels", 0.5,
               "The maximum fraction of masked pixels allowed before an input image is dropped.",
               "core", lambda x: _is_num(x) and 0.0 <= x <= 1.0),
    _ParamInfo("max_results", 100_000, "The maximum number of results to save after all filtering.",
               "filtering", lambda x: isinstance(x, int)),
    _ParamInfo("near_dup_thresh", 10,
               "The threshold for considering two observations as near duplicates (in pixels).",
               "filtering", lambda x: isinstance(x, int)),
    _ParamInfo("nightly_coadds", False,
               "If True, generate an additional coadd for each calendar date.",
               "stamps", lambda x: isinstance(x, bool)),
    _ParamInfo("num_obs", 10,
               "The minimum number of valid observations for the trajectory to be accepted.",
               "filtering", lambda x: isinstance(x, int)),
    _ParamInfo("peak_offset_max", None,
               "Maximum allowed offset (in pixels) between predicted and detected peak positions.",
               "filtering", lambda x: _is_num(x) or x is None),
    _ParamInfo("pred_line_cluster", False, "If True, applies line clustering to the predicted lines.",
               "filtering", lambda x: isinstance(x, bool)),
    _ParamInfo("pred_line_params", [4.0, 2, 60], "Parameters for the line prediction model.",
               "filtering", lambda x: isinstance(x, list) and len(x) == 3),
    _ParamInfo("psf_val", 1.4,
               "The default standard deviation of the Gaussian PSF in pixels (if not provided in the data).",
               "core", lambda x: _is_num(x) and x > 0.0),
    _ParamInfo("result_filename", None, "The filename to which results will be saved.",
               "core", lambda x: isinstance(x, str) or x is None),
    _ParamInfo("results_per_pixel", 8, "The maximum number of results to return from the GPU per pixel.",
               "filtering", lambda x: isinstance(x, int) and x > 0),
    _ParamInfo("save_all_stamps", False, "If True, save all stamps to the results.",
               "output", lambda x: isinstance(x, bool)),
    _ParamInfo("save_config", True, "If True, save the configuration used for processing.",
               "output", lambda x: isinstance(x, bool)),
    _ParamInfo("separate_col_files", ["all_stamps"],
               "List of regex for the names of the columns to save in separate files.",
               "output", lambda x: isinstance(x, list) and all(isinstance(i, str) for i in x)),
    _ParamInfo("sigmaG_filter", True, "If True, apply sigmaG filtering.",
               "filtering", lambda x: isinstance(x, bool)),
    _ParamInfo("sigmaG_lims", [25, 75], "The lower and upper limits for sigmaG filtering.",
               "filtering", lambda x: len(x) == 2 and x[0] < x[1] and all(_is_num(i) for i in x)),
    _ParamInfo("stamp_radius", 10, "The radius (in pixels) of the stamp to extract.",
               "stamps", lambda x: isinstance(x, int) and x > 0),
    _ParamInfo("stamp_type", "sum", "The type of stamp to extract.",
               "stamps", lambda x: x in ["sum", "mean", "median", "weighted"]),
    _ParamInfo("timeout_hours", None,
               "The maximum number of hours to allow the search to run (soft timeout).", "other"),
    _ParamInfo("track_filtered", False, "If True, track the filtered objects in the results table.",
               "filtering", lambda x: isinstance(x, bool)),
    _ParamInfo("x_pixel_bounds", None,
               "The x pixel bounds for the search starting location (None = use every pixel).",
               "core", lambda x: x is None or (len(x) == 2 and x[0] < x[1])),
    _ParamInfo("x_pixel_buffer", None,
               "If not None, the number of x pixels beyond the image bounds to use for starting coordinates.",
               "core", lambda x: x is None or (isinstance(x, int) and x >= 0)),
    _ParamInfo("y_pixel_bounds", None,
               "The y pixel bounds for the search starting location (None = use every pixel).",
               "core", lambda x: x is None or (len(x) == 2 and x[0] < x[1])),
    _ParamInfo("y_pixel_buffer", None,
               "If not None, the number of y pixels beyond the image bounds to use for starting coordinates.",
               "core", lambda x: x is None or (isinstance(x, int) and x >= 0)),
]


class SearchConfiguration:
    """A collection of configuration parameter settings with dict-style
    access, validation, and YAML/file serialization."""

    def __init__(self, data=None):
        self._param_info = {p.name: p for p in _SUPPORTED_PARAMS}
        self._params = {p.name: copy.deepcopy(p.default_value) for p in _SUPPORTED_PARAMS}
        if data is not None:
            self.set_multiple(data)

    def __contains__(self, key):
        return key in self._params

    def __getitem__(self, key):
        return self._params[key]

    def __str__(self):
        return "\n".join(f"{k}: {v}" for k, v in sorted(self._params.items()))

    def __eq__(self, other):
        if not isinstance(other, SearchConfiguration):
            return NotImplemented
        return self._params == other._params

    def copy(self):
        new = SearchConfiguration()
        new._params = copy.deepcopy(self._params)
        return new

    def set(self, param, value, warn_on_unknown=False):
        """Set a single parameter. Unknown parameters are allowed (stored)
        but may be flagged with a warning."""
        if warn_on_unknown and param not in self._params:
            logger.warning(f"Unknown parameter {param}.")
        self._params[param] = value

    def set_multiple(self, overwrite):
        for key, value in overwrite.items():
            self.set(key, value)

    def unset(self, param):
        """Restore a parameter to its default value."""
        if param in self._param_info:
            self._params[param] = copy.deepcopy(self._param_info[param].default_value)
        else:
            self._params.pop(param, None)

    def validate(self):
        """Check every known parameter against its validator; raise
        ValueError on failure."""
        for name, info in self._param_info.items():
            value = self._params.get(name, None)
            if not info.validate(value):
                raise ValueError(f"Invalid value for parameter {name}: {value}")
        return True

    def help(self, param=None):
        """Print parameter documentation, grouped by section."""
        if param is not None:
            if param in self._param_info:
                print(str(self._param_info[param]))
            else:
                print(f"Unknown parameter {param}")
            return
        by_section = {}
        for info in self._param_info.values():
            by_section.setdefault(info.section, []).append(info)
        for section in sorted(by_section):
            print(f"=== {section} ===")
            for info in sorted(by_section[section], key=lambda p: p.name):
                print(f"  {info}")

    # --- serialization ---

    @classmethod
    def from_dict(cls, d):
        return cls(data=d)

    def to_dict(self):
        return copy.deepcopy(self._params)

    @classmethod
    def from_yaml(cls, config):
        """Build from a YAML string or stream."""
        yaml_params = _yaml().safe_load(config)
        return cls.from_dict(yaml_params)

    def to_yaml(self):
        return _yaml().dump(self.to_dict())

    @classmethod
    def from_file(cls, filename, strict=True):
        path = Path(filename)
        if not path.is_file():
            if strict:
                raise FileNotFoundError(f"Configuration file {filename} not found.")
            return cls()
        with open(path) as handle:
            return cls.from_yaml(handle)

    def to_file(self, filename, overwrite=False):
        path = Path(filename)
        if path.exists() and not overwrite:
            raise FileExistsError(f"Configuration file {filename} already exists.")
        with open(path, "w") as handle:
            handle.write(self.to_yaml())

    @classmethod
    def from_table(cls, table):
        """Build from a single-row table: either one column per parameter
        with YAML-dumped cells (the reference layout,
        configuration.py:530-553) or a single 'yaml' column holding the
        whole dump."""
        if len(table) != 1:
            raise ValueError(f"Expected a single-row table. Received {len(table)} rows.")
        if "yaml" in table.colnames:
            return cls.from_yaml(table["yaml"][0])
        yaml = _yaml()
        params = {name: yaml.safe_load(str(table[name][0])) for name in table.colnames}
        return cls.from_dict(params)

    def to_table(self):
        from kbmod_tpu_torch.table import Table

        return Table({"yaml": [self.to_yaml()]})

    @classmethod
    def from_hdu(cls, hdu):
        """Build from a FITS HDU (not ported yet)."""
        raise NotImplementedError(_FITS_DEFERRED)

    def to_hdu(self):
        """The configuration as a FITS HDU (not ported yet)."""
        raise NotImplementedError(_FITS_DEFERRED)

    def to_reference_hdu(self):
        """The reference's one-row BINTABLE layout (not ported yet)."""
        raise NotImplementedError(_FITS_DEFERRED)
