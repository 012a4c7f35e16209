from kbmod_tpu_torch.standardizers.standardizer import Standardizer, StandardizerConfig
from kbmod_tpu_torch.standardizers.fits_standardizer import (
    FitsStandardizer,
    FitsStandardizerConfig,
    SingleExtensionFits,
    MultiExtensionFits,
)
from kbmod_tpu_torch.standardizers.kbmodv1 import KBMODV1, KBMODV1Config
from kbmod_tpu_torch.standardizers.kbmodv05 import KBMODV0_5, KBMODV0_5Config

try:  # The Butler standardizer requires the (optional) LSST stack.
    from kbmod_tpu_torch.standardizers.butler_standardizer import ButlerStandardizer, ButlerStandardizerConfig
except ImportError:  # pragma: no cover
    pass

__all__ = [
    "Standardizer",
    "StandardizerConfig",
    "FitsStandardizer",
    "FitsStandardizerConfig",
    "SingleExtensionFits",
    "MultiExtensionFits",
    "KBMODV1",
    "KBMODV1Config",
    "KBMODV0_5",
    "KBMODV0_5Config",
]
