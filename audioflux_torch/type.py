"""Drop-in alias of :mod:`audioflux_torch.types`.

The reference package exposes its enums as ``audioflux.type`` (singular);
user code does ``from audioflux.type import WindowType, ...``.  This alias
lets such imports port by renaming only the package.
"""

from audioflux_torch.types import *  # noqa: F401,F403
