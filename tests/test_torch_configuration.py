"""The port's SearchConfiguration against the JAX package's: every
parameter's default, section and validator verdicts, the dict, YAML and
FITS round trips, and the forms it serves without PyYAML (dict). Exact
equality throughout."""

import math
import sys

import pytest

from kbmod_tpu.configuration import SearchConfiguration, _SUPPORTED_PARAMS

from kbmod_tpu_torch.configuration import SearchConfiguration as TSearchConfiguration
from kbmod_tpu_torch.configuration import _SUPPORTED_PARAMS as T_SUPPORTED_PARAMS
from kbmod_tpu_torch.table import Table

PARAMS = sorted(p.name for p in _SUPPORTED_PARAMS)

# Values each validator is asked about: valid and invalid ones of every
# type a parameter takes.
PROBES = [
    None, True, False, 0, 1, -1, 2, 4, 7, 0.5, 1.5, -0.5, 100.0, math.nan, "sum", "mean", "median", "weighted",
    "all", "resnet18", "bad", [], [1], [25, 75], [75, 25], [0.0, 1.0], [4.0, 2, 60], ["mean", "weighted"],
    ["bogus"], ["all_stamps"], {"name": "X"}, {"velocities": [1]}, {"g": 1.0},
]


def _by_name(params):
    return {p.name: p for p in params}


def test_same_parameters():
    assert sorted(p.name for p in T_SUPPORTED_PARAMS) == PARAMS
    assert len(PARAMS) == 45


@pytest.mark.parametrize("name", PARAMS)
def test_parameter_matches(name):
    ref, got = _by_name(_SUPPORTED_PARAMS)[name], _by_name(T_SUPPORTED_PARAMS)[name]
    assert got.default_value == ref.default_value
    assert got.section == ref.section
    assert got.description == ref.description
    assert got.required == ref.required
    for value in PROBES:
        try:
            want = ref.validate(value)
        except Exception as err:  # the validator itself raises on this type
            with pytest.raises(type(err)):
                got.validate(value)
            continue
        assert got.validate(value) == want, value


def test_defaults_validate_and_equal():
    ref, got = SearchConfiguration(), TSearchConfiguration()
    assert got.validate()
    assert got.to_dict() == ref.to_dict()
    assert got["generator_config"]["angles"] == [-math.pi / 15, math.pi / 15, 129]


def test_invalid_values_raise():
    for key, val in (("results_per_pixel", -1), ("x_pixel_bounds", [20, 10]), ("encode_num_bytes", 3)):
        cfg = TSearchConfiguration({key: val})
        with pytest.raises(ValueError):
            cfg.validate()


def test_dict_round_trip():
    data = {"num_obs": 7, "lh_level": 12.5, "coadds": ["mean"], "x_pixel_bounds": [3, 40], "unknown_extra": 1}
    got = TSearchConfiguration.from_dict(data)
    again = TSearchConfiguration.from_dict(got.to_dict())
    assert again == got
    assert again.to_dict() == SearchConfiguration.from_dict(data).to_dict()
    got.unset("num_obs")
    assert got["num_obs"] == 10


def test_yaml_round_trip_both_ways(tmp_path):
    data = {"num_obs": 7, "sigmaG_lims": [20, 80], "generator_config": {"name": "SingleVelocitySearch", "vx": 1.0, "vy": 2.0}}
    got = TSearchConfiguration(data)
    assert TSearchConfiguration.from_yaml(got.to_yaml()) == got
    assert SearchConfiguration.from_yaml(got.to_yaml()).to_dict() == got.to_dict()
    assert TSearchConfiguration.from_yaml(SearchConfiguration(data).to_yaml()) == got
    path = tmp_path / "cfg.yaml"
    got.to_file(path)
    assert TSearchConfiguration.from_file(path) == got
    with pytest.raises(FileExistsError):
        got.to_file(path)
    assert TSearchConfiguration.from_table(got.to_table()) == got
    # The reference's layout: one column a parameter, each cell a YAML dump.
    ref_layout = Table({"num_obs": ["7"], "sigmaG_lims": ["[20, 80]"]})
    from_ref = TSearchConfiguration.from_table(ref_layout)
    assert from_ref.to_dict() == SearchConfiguration.from_table(ref_layout).to_dict()
    assert from_ref["sigmaG_lims"] == [20, 80]


def test_yaml_forms_name_pyyaml_when_missing(monkeypatch):
    monkeypatch.setitem(sys.modules, "yaml", None)
    cfg = TSearchConfiguration({"num_obs": 3})
    with pytest.raises(ImportError, match="PyYAML"):
        cfg.to_yaml()
    with pytest.raises(ImportError, match="PyYAML"):
        TSearchConfiguration.from_yaml("num_obs: 3")
    assert TSearchConfiguration.from_dict(cfg.to_dict()) == cfg


def test_fits_forms_are_deferred(tmp_path):
    """The three FITS forms (no longer deferred): each HDU equals the JAX
    package's and round-trips, through a file too."""
    from kbmod_tpu.io import fits_io as j_fits_io
    from kbmod_tpu_torch.io import fits_io

    data = {"num_obs": 7, "sigmaG_lims": [20, 80], "color_scale": {"r": 0.1}, "result_filename": "out dir/x.ecsv"}
    cfg = TSearchConfiguration(data)
    for form in ("to_hdu", "to_reference_hdu"):
        hdu, jhdu = getattr(cfg, form)(), getattr(SearchConfiguration(data), form)()
        assert hdu.header == jhdu.header
        assert getattr(hdu, "columns", None) == getattr(jhdu, "columns", None)
        assert TSearchConfiguration.from_hdu(hdu) == cfg
        path = str(tmp_path / f"{form}.fits")
        fits_io.write_fits(path, [fits_io.ImageHDU(name="PRIMARY"), hdu])
        assert TSearchConfiguration.from_hdu(fits_io.read_fits(path)[1]) == cfg
        assert SearchConfiguration.from_hdu(j_fits_io.read_fits(path)[1]).to_dict() == cfg.to_dict()

