"""Matplotlib display helpers; matplotlib is imported only when one is
called (the card's machine has none, and the plans never need it)."""

from audioflux_torch.display.display import fill_plot, fill_spec, fill_wave
from audioflux_torch.display.plot import Plot


def __getattr__(name):
    if name in ("TimeFormatter", "ChromaFormatter"):
        from audioflux_torch.display import display as _display
        return getattr(_display, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
