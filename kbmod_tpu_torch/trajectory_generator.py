"""Candidate trajectory generators.

Port of the JAX package's trajectory_generator.py, API-compatible with the
reference's kbmod.trajectory_generator (src/kbmod/trajectory_generator.py):
a registry of named strategies, each
yielding ``Trajectory(vx, vy)`` candidates to test at every pixel, created
from a config dict via ``create_trajectory_generator``.

Every generator also exposes ``velocity_arrays()`` returning (vxs, vys) as
numpy float32 arrays: the device search consumes the struct-of-arrays form
directly instead of a Python object loop.

Unit handling is a minimal internal converter (no astropy): angles accept
radian/degree/arcmin/arcsec, velocities accept pix/day (and pix/hour). A
WorkUnit's ecliptic angle needs its WCS, which the port does not have yet:
the generators that would read it raise NotImplementedError instead.
"""

import abc
import copy
import logging
import math

import numpy as np

from kbmod_tpu_torch.configuration import SearchConfiguration
from kbmod_tpu_torch.search.trajectory import Trajectory

logger = logging.getLogger(__name__)

_WCS_DEFERRED = "the ecliptic angle of a WorkUnit needs its WCS, which the port does not have yet"

_ANGLE_TO_RAD = {
    "radian": 1.0,
    "rad": 1.0,
    "degree": math.pi / 180.0,
    "deg": math.pi / 180.0,
    "arcmin": math.pi / (180.0 * 60.0),
    "arcsec": math.pi / (180.0 * 3600.0),
    "arcsecond": math.pi / (180.0 * 3600.0),
}

_VEL_TO_PIX_PER_DAY = {
    "pix / d": 1.0,
    "pix/d": 1.0,
    "pix / day": 1.0,
    "pixel / day": 1.0,
    "pix / h": 24.0,
    "pix / hr": 24.0,
}


def angle_to_radians(value, units):
    key = str(units).strip().lower()
    if key not in _ANGLE_TO_RAD:
        raise ValueError(f"Unsupported angle unit {units}")
    return value * _ANGLE_TO_RAD[key]


def velocity_to_pix_per_day(value, units):
    key = str(units).strip().lower()
    if key not in _VEL_TO_PIX_PER_DAY:
        raise ValueError(f"Unsupported velocity unit {units}")
    return value * _VEL_TO_PIX_PER_DAY[key]


def create_trajectory_generator(config, work_unit=None, **kwargs):
    """Create a TrajectoryGenerator from a config dict (or a full
    SearchConfiguration holding ``generator_config``); the ``name`` entry
    selects the registered generator class."""
    if isinstance(config, SearchConfiguration):
        if config["generator_config"] is None:
            raise ValueError("Missing generator_config parameter.")
        config = config["generator_config"]

    if "name" not in config:
        raise KeyError("The trajectory generator configuration must contain a name field.")
    name = config["name"]
    if name not in TrajectoryGenerator.generators:
        raise KeyError(f"Trajectory generator {name} is undefined.")
    logger.info(f"Creating trajectory generator of type {name}")

    params = copy.deepcopy(dict(config))
    params.update(kwargs)
    return TrajectoryGenerator.generators[name](**params, work_unit=work_unit)


def describe_trajectory_generator(name=None):
    """Print the docstring of one (or all) registered generators."""
    if name:
        if name in TrajectoryGenerator.generators:
            print(TrajectoryGenerator.generators[name].__doc__)
        else:
            print(f"Trajectory generator {name} is not defined.")
    else:
        print("Available trajectory generators:")
        for cls in TrajectoryGenerator.generators.values():
            print(f"\n=== {cls.__name__} ===\n{cls.__doc__}")


class TrajectoryGenerator(abc.ABC):
    """Base class: a finite strategy producing candidate (vx, vy) pairs."""

    generators = {}

    def __init__(self, work_unit=None, **kwargs):
        pass

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        cls.generators[cls.__name__] = cls

    def __enter__(self):
        self.initialize()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.close()
        return exc_type is None

    def __next__(self, *args, **kwargs):
        return next(self.generate(*args, **kwargs))

    def __iter__(self):
        return self.generate()

    def initialize(self, *args, **kwargs):
        pass

    def close(self, *args, **kwargs):
        pass

    @abc.abstractmethod
    def generate(self, *args, **kwargs):
        """Yield candidate Trajectory objects."""
        raise NotImplementedError()

    def velocity_arrays(self):
        """(vxs, vys) numpy float32 arrays of all candidates (consumed by
        the device search)."""
        vxs, vys = [], []
        for trj in self:
            vxs.append(trj.vx)
            vys.append(trj.vy)
        return np.asarray(vxs, dtype=np.float32), np.asarray(vys, dtype=np.float32)

    def to_table(self):
        """All candidates as a Table with x/y/vx/vy columns."""
        from kbmod_tpu_torch.table import Table

        data = {"x": [], "y": [], "vx": [], "vy": []}
        for trj in self:
            data["x"].append(trj.x)
            data["y"].append(trj.y)
            data["vx"].append(trj.vx)
            data["vy"].append(trj.vy)
        return Table(data)


class SingleVelocitySearch(TrajectoryGenerator):
    """Search a single velocity (vx, vy) in pixels per day."""

    def __init__(self, vx, vy, **kwargs):
        super().__init__(**kwargs)
        if not np.isfinite(vx):
            raise ValueError(f"Invalid vx value for SingleVelocitySearch = {vx}")
        if not np.isfinite(vy):
            raise ValueError(f"Invalid vy value for SingleVelocitySearch = {vy}")
        self.vx = vx
        self.vy = vy

    def __repr__(self):
        return f"SingleVelocitySearch: vx={self.vx}, vy={self.vy}"

    __str__ = __repr__

    def __len__(self):
        return 1

    def generate(self, *args, **kwargs):
        yield Trajectory(vx=self.vx, vy=self.vy)


class VelocityGridSearch(TrajectoryGenerator):
    """A rectangular grid in (vx, vy) space, endpoints inclusive.

    Parameters: vx_steps, min_vx, max_vx, vy_steps, min_vy, max_vy
    (velocities in pixels per day)."""

    def __init__(self, vx_steps, min_vx, max_vx, vy_steps, min_vy, max_vy, **kwargs):
        super().__init__(**kwargs)
        if vx_steps < 2 or vy_steps < 2:
            raise ValueError("VelocityGridSearch requires at least 2 steps in each dimension")
        if max_vx < min_vx or max_vy < min_vy or not np.all(np.isfinite([min_vx, max_vx, min_vy, max_vy])):
            raise ValueError(
                f"Invalid VelocityGridSearch bounds. Got: min_vx={min_vx}, max_vx={max_vx}, "
                f"min_vy={min_vy}, max_vy={max_vy}"
            )
        self.vx_steps = vx_steps
        self.min_vx = min_vx
        self.max_vx = max_vx
        self.vx_stepsize = (max_vx - min_vx) / float(vx_steps - 1)
        self.vy_steps = vy_steps
        self.min_vy = min_vy
        self.max_vy = max_vy
        self.vy_stepsize = (max_vy - min_vy) / float(vy_steps - 1)

    def __repr__(self):
        return (
            f"VelocityGridSearch: vx=[{self.min_vx}, {self.max_vx}], {self.vx_steps}"
            f" vy=[{self.min_vy}, {self.max_vy}], {self.vy_steps}"
        )

    __str__ = __repr__

    def __len__(self):
        return self.vy_steps * self.vx_steps

    def generate(self, *args, **kwargs):
        for vy_i in range(self.vy_steps):
            for vx_i in range(self.vx_steps):
                yield Trajectory(
                    vx=self.min_vx + vx_i * self.vx_stepsize,
                    vy=self.min_vy + vy_i * self.vy_stepsize,
                )


class PencilSearch(TrajectoryGenerator):
    """A small cone around a central velocity, varying angle by
    +/- max_ang_offset (radians) and magnitude by +/- max_vel_offset
    (pixels per day)."""

    def __init__(self, vx, vy, max_ang_offset=0.2618, ang_step=0.035,
                 max_vel_offset=10.0, vel_step=0.5, **kwargs):
        super().__init__(**kwargs)
        params = np.array([vx, vy, ang_step, vel_step, max_ang_offset, max_vel_offset])
        if (
            not np.all(np.isfinite(params))
            or ang_step <= 0
            or vel_step <= 0
            or max_ang_offset < 0
            or max_vel_offset < 0
        ):
            raise ValueError(
                "Invalid parameters. All ranges and step sizes must be finite and > 0. "
                f"Got: vx={vx}, vy={vy}, ang_step={ang_step}, vel_step={vel_step}, "
                f"max_ang_offset={max_ang_offset}, max_vel_offset={max_vel_offset}"
            )
        self.center_vx = vx
        self.center_vy = vy
        if vx == 0.0 and vy == 0.0:
            self.center_ang = 0.0
            self.center_vel = 0.0
        else:
            self.center_ang = float(np.arctan2(vy, vx))
            self.center_vel = float(np.hypot(vx, vy))

        self.min_ang = self.center_ang - max_ang_offset
        self.max_ang = self.center_ang + max_ang_offset
        self.ang_step = ang_step
        self.ang_array = np.arange(self.min_ang, self.max_ang + 1e-8, ang_step)

        self.min_vel = max(self.center_vel - max_vel_offset, 0.0)
        self.max_vel = self.center_vel + max_vel_offset
        self.vel_step = vel_step
        self.vel_array = np.arange(self.min_vel, self.max_vel + 1e-8, vel_step)

    def __repr__(self):
        return (
            f"PencilSearch: v=[{self.min_vel}, {self.max_vel}), {self.vel_step}"
            f" a=[{self.min_ang}, {self.max_ang}), {self.ang_step}"
        )

    __str__ = __repr__

    def __len__(self):
        return len(self.ang_array) * len(self.vel_array)

    def generate(self, *args, **kwargs):
        for ang in self.ang_array:
            for vel in self.vel_array:
                yield Trajectory(vx=np.cos(ang) * vel, vy=np.sin(ang) * vel)


class KBMODV1Search(TrajectoryGenerator):
    """A polar grid: vel_steps magnitudes in [min_vel, max_vel) crossed with
    ang_steps angles in [min_ang, max_ang) — half-open ranges, matching the
    KBMOD v1 parameterization."""

    def __init__(self, vel_steps, min_vel, max_vel, ang_steps, min_ang, max_ang, **kwargs):
        super().__init__(**kwargs)
        if vel_steps < 1 or ang_steps < 1:
            raise ValueError(
                f"KBMODV1Search requires at least 1 step in each dimension. "
                f"Got vel_steps={vel_steps}, ang_steps={ang_steps}."
            )
        if max_vel < min_vel or max_ang < min_ang or not np.all(np.isfinite([min_vel, max_vel, min_ang, max_ang])):
            raise ValueError(
                f"Invalid KBMODV1Search bounds. Got: min_vel={min_vel}, max_vel={max_vel}, "
                f"min_ang={min_ang}, max_ang={max_ang}."
            )
        self.vel_steps = vel_steps
        self.min_vel = min_vel
        self.max_vel = max_vel
        self.vel_stepsize = (max_vel - min_vel) / float(vel_steps)
        self.ang_steps = ang_steps
        self.min_ang = min_ang
        self.max_ang = max_ang
        self.ang_stepsize = (max_ang - min_ang) / float(ang_steps)

    def __repr__(self):
        return (
            f"KBMODV1Search: v=[{self.min_vel}, {self.max_vel}), {self.vel_steps}"
            f" a=[{self.min_ang}, {self.max_ang}), {self.ang_steps}"
        )

    __str__ = __repr__

    def __len__(self):
        return self.ang_steps * self.vel_steps

    def generate(self, *args, **kwargs):
        for ang_i in range(self.ang_steps):
            for vel_i in range(self.vel_steps):
                ang = self.min_ang + ang_i * self.ang_stepsize
                vel = self.min_vel + vel_i * self.vel_stepsize
                yield Trajectory(vx=math.cos(ang) * vel, vy=math.sin(ang) * vel)


class KBMODV1SearchConfig(KBMODV1Search):
    """The legacy KBMOD v1 config-file parameterization: v_arr =
    [min_vel, max_vel, vel_steps], ang_arr = [min_offset, max_offset,
    ang_steps] around ``average_angle`` (or the WorkUnit's ecliptic)."""

    def __init__(self, v_arr, ang_arr, average_angle=None, work_unit=None, **kwargs):
        if len(v_arr) != 3:
            raise ValueError("KBMODV1SearchConfig requires v_arr to be length 3")
        if len(ang_arr) != 3:
            raise ValueError("KBMODV1SearchConfig requires ang_arr to be length 3")
        if average_angle is None:
            if work_unit is None:
                raise ValueError(
                    "KBMODV1SearchConfig requires a valid average_angle or a WorkUnit with a WCS."
                )
            raise NotImplementedError(_WCS_DEFERRED)
        ang_min = average_angle - ang_arr[0]
        ang_max = average_angle + ang_arr[1]
        super().__init__(int(v_arr[2]), v_arr[0], v_arr[1], int(ang_arr[2]), ang_min, ang_max, **kwargs)


class EclipticCenteredSearch(TrajectoryGenerator):
    """A polar grid centered on the ecliptic angle: velocities =
    [min, max, steps] (endpoints inclusive), angles = [min_offset,
    max_offset, steps] relative to the ecliptic (endpoints inclusive).

    The ecliptic angle comes from ``given_ecliptic`` if set, else from the
    WorkUnit's WCS, else 0.0."""

    def __init__(self, velocities=[0.0, 0.0, 0], angles=[0.0, 0.0, 0], angle_units="radian",
                 velocity_units="pix / d", given_ecliptic=None, work_unit=None, **kwargs):
        super().__init__(**kwargs)
        if given_ecliptic is not None:
            self.ecliptic_angle = angle_to_radians(given_ecliptic, angle_units)
        elif work_unit is not None:
            raise NotImplementedError(_WCS_DEFERRED)
        else:
            logger.warning("No ecliptic angle provided. Using 0.0.")
            self.ecliptic_angle = 0.0

        if len(angles) != 3 or not np.all(np.isfinite(angles)):
            raise ValueError(f"Invalid angles parameter. Expected a length 3 list. Got {angles}")
        if len(velocities) != 3 or not np.all(np.isfinite(velocities)):
            raise ValueError(f"Invalid velocity parameter. Expected a length 3 list. Got {velocities}")
        if angles[2] < 1:
            raise ValueError(f"EclipticCenteredSearch requires at least 1 step in angles. Got {angles[2]}")
        if velocities[1] < velocities[0]:
            raise ValueError(f"Invalid EclipticCenteredSearch velocities: {velocities[1]} < {velocities[0]}")
        if velocities[2] < 1:
            raise ValueError(f"EclipticCenteredSearch requires at least 1 step in velocities. Got {velocities[2]}")

        self.velocities = [
            velocity_to_pix_per_day(velocities[0], velocity_units),
            velocity_to_pix_per_day(velocities[1], velocity_units),
            int(velocities[2]),
        ]
        self.vel_stepsize = (velocities[1] - velocities[0]) / float(velocities[2] - 1) if velocities[2] > 1 else 0.0

        self.angles = [
            angle_to_radians(angles[0], angle_units),
            angle_to_radians(angles[1], angle_units),
            int(angles[2]),
        ]
        self.min_ang = self.ecliptic_angle + self.angles[0]
        self.max_ang = self.ecliptic_angle + self.angles[1]
        self.ang_stepsize = (self.max_ang - self.min_ang) / float(self.angles[2] - 1) if self.angles[2] > 1 else 0.0

    def __repr__(self):
        return (
            f"EclipticSearch: v=[{self.velocities[0]}, {self.velocities[1]}], {self.velocities[2]}"
            f" a=[{self.min_ang}, {self.max_ang}], {self.angles[2]}"
        )

    def __str__(self):
        return (
            f"EclipticSearch: Vel: [{self.velocities[0]}, {self.velocities[1]}] in "
            f"{self.velocities[2]} steps; Ang: ecliptic={self.ecliptic_angle} "
            f"[{self.min_ang}, {self.max_ang}] in {self.angles[2]} steps."
        )

    def __len__(self):
        return self.angles[2] * self.velocities[2]

    def generate(self, *args, **kwargs):
        for ang_i in range(self.angles[2]):
            for vel_i in range(self.velocities[2]):
                ang = self.min_ang + ang_i * self.ang_stepsize
                vel = self.velocities[0] + vel_i * self.vel_stepsize
                yield Trajectory(vx=math.cos(ang) * vel, vy=math.sin(ang) * vel)


class RandomVelocitySearch(TrajectoryGenerator):
    """Uniformly random velocities within [min_vx, max_vx] x [min_vy,
    max_vy], up to max_samples candidates."""

    def __init__(self, min_vx, max_vx, min_vy, max_vy, max_samples=1_000_000, seed=None, **kwargs):
        super().__init__(**kwargs)
        if max_vx < min_vx or max_vy < min_vy or not np.all(np.isfinite([min_vx, max_vx, min_vy, max_vy])):
            raise ValueError(
                f"Invalid RandomVelocitySearch bounds: [{min_vx}, {max_vx}] and [{min_vy}, {max_vy}]"
            )
        if max_samples <= 0:
            raise ValueError(f"Invalid maximum samples: {max_samples}")
        self.min_vx = min_vx
        self.max_vx = max_vx
        self.min_vy = min_vy
        self.max_vy = max_vy
        self.samples_left = max_samples
        self._rng = np.random.default_rng(seed)

    def __repr__(self):
        return f"RandomVelocitySearch: vx=[{self.min_vx}, {self.max_vx}] vy=[{self.min_vy}, {self.max_vy}]"

    __str__ = __repr__

    def __len__(self):
        return self.samples_left

    def reset_sample_count(self, max_samples):
        if max_samples <= 0:
            raise ValueError("Invalid maximum samples.")
        self.samples_left = max_samples

    def generate(self, *args, **kwargs):
        while self.samples_left > 0:
            self.samples_left -= 1
            yield Trajectory(
                vx=self.min_vx + self._rng.random() * (self.max_vx - self.min_vx),
                vy=self.min_vy + self._rng.random() * (self.max_vy - self.min_vy),
            )
