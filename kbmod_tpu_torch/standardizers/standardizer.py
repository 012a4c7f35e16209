"""The Standardizer plugin system.

Copy of the JAX package's standardizers/standardizer.py (host code). The
registry is this package's own: a class of the JAX package never resolves
here, nor one of this package there.

Behavior-compatible with the reference's kbmod.standardizers.standardizer
(src/kbmod/standardizers/standardizer.py): a registry of named plugins
that transform raw data (FITS files, Butler datasets, ...) into the
standardized science/variance/mask/PSF + metadata form KBMOD consumes.
Resolution (`Standardizer.get`) picks the highest-priority registered
volunteer, or a forced standardizer by name/class.
"""

import abc
import logging
import warnings

logger = logging.getLogger(__name__)

__all__ = ["Standardizer", "StandardizerConfig"]


class StandardizerConfig:
    """A dict-like configuration for a Standardizer; subclasses declare
    defaults as class attributes."""

    def __init__(self, config=None, **kwargs):
        # Collect class-level defaults (public, non-callable attributes).
        self._conf = {}
        for cls in reversed(type(self).__mro__):
            for key, value in vars(cls).items():
                if not key.startswith("_") and not callable(value) and not isinstance(value, (classmethod, staticmethod, property)):
                    self._conf[key] = value
        if config is not None:
            if isinstance(config, StandardizerConfig):
                self._conf.update(config.toDict())
            else:
                self._conf.update(dict(config))
        self._conf.update(kwargs)

    def __getitem__(self, key):
        return self._conf[key]

    def __setitem__(self, key, value):
        self._conf[key] = value

    def __contains__(self, key):
        return key in self._conf

    def __eq__(self, other):
        if isinstance(other, StandardizerConfig):
            return self._conf == other._conf
        if isinstance(other, dict):
            return self._conf == other
        return NotImplemented

    def __or__(self, other):
        if isinstance(other, StandardizerConfig):
            return self._conf | other._conf
        if isinstance(other, dict):
            return self._conf | other
        return NotImplemented

    def __iter__(self):
        return iter(self._conf)

    def __len__(self):
        return len(self._conf)

    def keys(self):
        return self._conf.keys()

    def values(self):
        return self._conf.values()

    def items(self):
        return self._conf.items()

    def update(self, config=None, **kwargs):
        if config is not None:
            conf = config.toDict() if isinstance(config, StandardizerConfig) else dict(config)
            self._conf.update(conf)
        self._conf.update(kwargs)

    def toDict(self):
        return dict(self._conf)


class Standardizer(abc.ABC):
    """Abstract base transforming raw data into KBMOD's standardized form.

    Subclasses with a non-None ``name`` register automatically; resolution
    prefers higher ``priority``; ``can_volunteer=False`` restricts a
    standardizer to explicit selection.
    """

    registry = dict()
    name = None
    priority = 0
    can_volunteer = True
    configClass = StandardizerConfig

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        if cls.name is not None:
            Standardizer.registry[cls.name] = cls

    def __init__(self, location=None, config=None, **kwargs):
        self.location = location
        self.processable = []
        self.config = self.configClass(config)

    def __str__(self):
        return f"{self.name}({self.location}, {self.processable})"

    def __repr__(self):
        return f"{type(self).__name__}({self.location})"

    @classmethod
    def get(cls, tgt, force=None, config=None, **kwargs):
        """Resolve and construct the standardizer for a target.

        ``force`` (name or class) bypasses resolution; otherwise all
        registered volunteers are polled and the highest-priority match is
        used.
        """
        if force is not None and isinstance(force, type):
            return force(tgt, config=config, **kwargs)
        if force is not None and isinstance(force, str):
            try:
                stdcls = cls.registry[force]
            except KeyError as e:
                raise KeyError(
                    "Standardizer must be a registered standardizer name or a class reference. "
                    f"Expected {', '.join(cls.registry)} got '{force}' instead."
                ) from e
            return stdcls(tgt, config=config, **kwargs)

        volunteers = []
        for standardizer in cls.registry.values():
            if standardizer.can_volunteer:
                resolved = standardizer.resolveTarget(tgt)
                can_std, resources = (resolved, {}) if isinstance(resolved, bool) else resolved
                if can_std:
                    volunteers.append((standardizer, resources))

        if not volunteers:
            raise ValueError(
                "None of the registered standardizers are able to process this source. "
                "You can provide your own. Refer to Standardizer documentation for details."
            )
        if len(volunteers) > 1:
            volunteers.sort(key=lambda v: v[0].priority, reverse=True)
            warnings.warn(
                f"Multiple standardizers declared the ability to standardize; using {volunteers[0][0].name}."
            )
        standardizer, resources = volunteers[0]
        return standardizer(tgt, config=config, **resources, **kwargs)

    @classmethod
    @abc.abstractmethod
    def resolveTarget(cls, tgt):
        """(canStandardize, resources) for a target."""
        raise NotImplementedError()

    @classmethod
    def canStandardize(cls, tgt):
        resolved = cls.resolveTarget(tgt)
        return resolved if isinstance(resolved, bool) else resolved[0]

    # --- abstract standardization interface ---

    @abc.abstractmethod
    def standardizeMetadata(self):
        """Dict of per-exposure metadata (must include 'location', 'mjd_mid',
        'ra', 'dec')."""
        raise NotImplementedError()

    @abc.abstractmethod
    def standardizeScienceImage(self):
        raise NotImplementedError()

    @abc.abstractmethod
    def standardizeVarianceImage(self):
        raise NotImplementedError()

    @abc.abstractmethod
    def standardizeMaskImage(self):
        raise NotImplementedError()

    @abc.abstractmethod
    def standardizeWCS(self):
        raise NotImplementedError()

    @abc.abstractmethod
    def standardizeBBox(self):
        raise NotImplementedError()

    @abc.abstractmethod
    def standardizePSF(self):
        raise NotImplementedError()

    def standardize(self):
        """The full standardized dict: metadata + science/variance/mask/PSF
        + wcs + bbox."""
        std = {"meta": self.standardizeMetadata()}
        std["science"] = self.standardizeScienceImage()
        std["variance"] = self.standardizeVarianceImage()
        std["mask"] = self.standardizeMaskImage()
        std["psf"] = self.standardizePSF()
        return std

    @abc.abstractmethod
    def toLayeredImage(self):
        """List of LayeredImagePy, one per processable unit."""
        raise NotImplementedError()
