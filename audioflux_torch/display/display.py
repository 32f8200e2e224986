"""Matplotlib helpers, full behavioral parity with the reference display
layer (``python/audioflux/display/display.py:11-309``): axis scale setup
(symlog base-2 for 'log'), per-axis tick formatters (adaptive h:mm:ss time
labels, chroma pitch-class labels from the chroma filter layout), and the
same ``fill_spec`` / ``fill_plot`` / ``fill_wave`` signatures.  matplotlib
imports stay lazy so headless feature extraction never pays for them.

Counterpart of ``audioflux_tpu/display/display.py``: a tensor on any device
is fetched to the host (``ops.backend.host_f32``; complex data keeps its
type, and ``fill_spec`` draws its magnitude) before it is drawn.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from audioflux_torch.ops.backend import host_f32

__all__ = ["fill_spec", "fill_plot", "fill_wave"]


def _host(a) -> np.ndarray:
    """``a`` (a tensor on any device, or host data) as a numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy() if a.is_complex() else host_f32(a)
    return np.asarray(a)


def _axes(axes):
    import matplotlib.axes as plaxes
    import matplotlib.pyplot as plt
    if axes is None:
        axes = plt.subplot()
    elif not isinstance(axes, plaxes.Axes):
        raise ValueError("`axes` must be an instance of "
                         "`matplotlib.axes.Axes`")
    return axes


def _axis_scale(axes, ax_name, ax_type):
    scaler = axes.set_xscale if ax_name == "x" else axes.set_yscale
    if ax_type == "log":
        # octave-spaced frequency axis: symlog, one decade per octave
        scaler("symlog", base=2, linthresh=64, linscale=0.5)
    else:
        scaler("linear")


def _time_formatter():
    from matplotlib.ticker import Formatter

    class TimeFormatter(Formatter):
        """Adaptive second/minute/hour tick labels (no fixed unit)."""

        def __init__(self, lag=False, unit=None):
            if unit not in ("s", "ms", None):
                raise ValueError(f"Time unit is not support: {unit}")
            self.unit = unit
            self.lag = lag

        def __call__(self, x, pos=None):
            _, dmax = self.axis.get_data_interval()
            vmin, vmax = self.axis.get_view_interval()
            sign = ""
            value = x
            if self.lag and x >= dmax * 0.5:
                if x > dmax:
                    return ""
                value = abs(x - dmax)
                sign = "-"
            if self.unit == "s":
                s = f"{value:.3g}"
            elif self.unit == "ms":
                s = f"{value * 1000:.3g}"
            else:
                span = vmax - vmin
                if span > 3600:
                    s = "{:d}:{:02d}:{:02d}".format(
                        int(value / 3600.0), int(np.mod(value / 60.0, 60)),
                        int(np.mod(value, 60)))
                elif span > 60:
                    s = "{:d}:{:02d}".format(int(value / 60.0),
                                             int(np.mod(value, 60)))
                elif span >= 1:
                    s = f"{value:.2g}"
                else:
                    s = f"{value:.3f}"
            return sign + s

    return TimeFormatter


def _chroma_formatter():
    from matplotlib.ticker import Formatter

    from audioflux_torch.utils.convert import midi_to_note

    class ChromaFormatter(Formatter):
        def __init__(self, bin_per_tone=1):
            self.bin_per_tone = bin_per_tone

        def __call__(self, x, pos=None):
            return midi_to_note(int(x) // self.bin_per_tone,
                                is_octave=False)

    return ChromaFormatter


def _axis_decorate(axis, ax_type, coords):
    from matplotlib.ticker import (FixedLocator, MaxNLocator,
                                   ScalarFormatter, SymmetricalLogLocator)

    if ax_type is None:
        if len(coords) <= 2:
            axis.set_ticks(coords)
        axis.set_label_text("")
    elif ax_type == "time":
        axis.set_major_formatter(_time_formatter()(unit=None, lag=False))
        axis.set_major_locator(
            MaxNLocator(prune=None, steps=[1, 1.5, 5, 6, 10]))
        axis.set_label_text("Time")
    elif ax_type == "log":
        axis.set_major_formatter(ScalarFormatter())
        axis.set_major_locator(
            SymmetricalLogLocator(axis.get_transform()))
    elif ax_type == "linear":
        axis.set_major_formatter(ScalarFormatter())
    elif ax_type == "chroma":
        n = len(coords)
        if (n - 1) % 12 != 0:
            raise ValueError(f"The number={n - 1} of y-axis scales of "
                             "chroma must be a multiple of 12")
        bin_per_tone = (n - 1) // 12
        axis.set_major_formatter(
            _chroma_formatter()(bin_per_tone=bin_per_tone))
        # major ticks at the diatonic degrees (C D E F G A B)
        degrees = np.array([0, 2, 4, 5, 7, 9, 11])
        axis.set_major_locator(FixedLocator(degrees * bin_per_tone))
        axis.set_label_text("Pitch class")
    else:
        raise ValueError(f"Unsupported axis type: {ax_type}")


def fill_spec(data, axes=None, x_coords=None, y_coords=None,
              x_axis=None, y_axis=None, title=""):
    """Render a (fre, time) matrix; returns the QuadMesh collection.

    ``x_axis``/``y_axis``: None | 'linear' | 'log' | 'chroma' | 'time'.
    """
    import matplotlib as mpl

    data = _host(data)
    if np.iscomplexobj(data):
        warnings.warn("Display after performing abs on complex numbers")
        data = np.abs(data)
    if data.ndim != 2:
        raise ValueError(f"data[ndim={data.ndim}] must be a 2D array")
    axes = _axes(axes)

    if x_coords is None:
        x_coords = np.arange(data.shape[-1] + 1)
    if y_coords is None or y_axis == "chroma":
        y_coords = np.arange(data.shape[-2] + 1)

    if hasattr(mpl, "colormaps"):
        cmap = mpl.colormaps["plasma"]
    else:  # matplotlib < 3.5
        from matplotlib.cm import get_cmap
        cmap = get_cmap("plasma")

    collection = axes.pcolormesh(x_coords, y_coords, data, cmap=cmap)
    axes.set_xlim(np.min(x_coords), np.max(x_coords))
    axes.set_ylim(np.min(y_coords), np.max(y_coords))
    _axis_scale(axes, "x", x_axis)
    _axis_scale(axes, "y", y_axis)
    _axis_decorate(axes.xaxis, x_axis, x_coords)
    _axis_decorate(axes.yaxis, y_axis, y_coords)
    if title:
        axes.set_title(title)
    return collection


def fill_plot(x, y, axes=None, label="", is_legend=True, *,
              x_lims=None, y_lims=None, y_blank_threshold=0.15,
              title=None):
    """Render a labeled line plot with the reference's limit handling."""
    axes = _axes(axes)
    x = _host(x)
    y = _host(y)
    if x.ndim != 1:
        raise ValueError(f"x[ndim={x.ndim}] must be a 1D array")
    if y.ndim != 1:
        raise ValueError(f"y[ndim={y.ndim}] must be a 1D array")

    if not x_lims:
        x_lims = (np.min(x), np.max(x))
    if not y_lims:
        y_min, y_max = np.min(y), np.max(y)
        blank = np.abs(y_max - y_min) * y_blank_threshold
        y_lims = (y_min - blank, y_max + blank)
    axes.set_xlim(*tuple(x_lims))
    axes.set_ylim(*tuple(y_lims))
    axes.plot(x, y, label=label)
    if is_legend and label:
        axes.legend()
    if title:
        axes.set_title(title)
    return axes


def fill_wave(data, samplate=32000, axes=None, times=None, title=None):
    """Render a waveform against seconds (delegates to ``fill_plot``)."""
    data = _host(data)
    if data.ndim != 1:
        raise ValueError(f"data[ndim={data.ndim}] must be a 1D array")
    if times is None:
        times = np.arange(data.shape[-1]) / samplate
    ax = fill_plot(times, data, axes=axes,
                   x_lims=(times[0], times[-1]),
                   is_legend=False, y_blank_threshold=0.15)
    if title:
        ax.set_title(title)
    return ax


def __getattr__(name):
    # public formatter classes (reference display.py:80-135) built lazily
    # so importing the package never requires matplotlib; memoized into
    # module globals so repeated access returns the same class object
    if name == "TimeFormatter":
        cls = _time_formatter()
        globals()[name] = cls
        return cls
    if name == "ChromaFormatter":
        cls = _chroma_formatter()
        globals()[name] = cls
        return cls
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
