"""Grid plot helper mirroring ``python/audioflux/display/plot.py:39-234``.

Counterpart of ``audioflux_tpu/display/plot.py``: a tensor on any device
is fetched to the host (``ops.backend.host_f32``) before it is drawn.
"""

from __future__ import annotations

import warnings

import numpy as np

__all__ = ["Plot"]


class Plot:
    """Subplot grid with the reference's method surface.

    ``row_idx``/``col_idx`` address a cell like the reference
    (``plot.py:70-194``); leaving both as None appends to the next free
    cell in reading order (an extension the examples use).
    """

    def __init__(self, nrows=1, ncols=1, sharex=False, sharey=False,
                 fig_width=8, fig_height=2.5, fig_kw=None):
        import matplotlib.pyplot as plt
        fig_kw = dict(fig_kw or {})
        fig_kw.setdefault("figsize", (fig_width * ncols, fig_height * nrows))
        self.nrows = nrows
        self.ncols = ncols
        self.fig, axes = plt.subplots(nrows, ncols, sharex=sharex,
                                      sharey=sharey, **fig_kw)
        self.axes = np.atleast_1d(axes)
        self._idx = 0

    def get_axes(self, row, col):
        """The Axes at grid cell (row, col) (``plot.py:46-68``)."""
        if self.nrows == 1 and self.ncols == 1:
            return self.axes.flat[0]
        if self.nrows == 1:
            return self.axes.flat[col]
        if self.ncols == 1:
            return self.axes.flat[row]
        return self.axes.reshape(self.nrows, self.ncols)[row, col]

    def _next_axes(self):
        ax = self.axes.flat[self._idx % self.axes.size]
        self._idx += 1
        return ax

    def _pick(self, row_idx, col_idx):
        if row_idx is None and col_idx is None:
            return self._next_axes()
        return self.get_axes(row_idx or 0, col_idx or 0)

    def add_spec_data(self, data, x_coords=None, y_coords=None, scale=None,
                      row_idx=None, col_idx=None, title=None, *,
                      show_colorbar=False, axis_option=None):
        """Render a (fre, time) matrix into a grid cell (``plot.py:70``)."""
        from audioflux_torch.display.display import fill_spec
        if y_coords is None and scale not in (None, "linear"):
            warnings.warn("If `y_coords` is None, `scale` must be linear")
            scale = "linear"
        ax = self._pick(row_idx, col_idx)
        img = fill_spec(data, axes=ax,
                        x_coords=x_coords, y_coords=y_coords,
                        x_axis=None if x_coords is None else "time",
                        y_axis=scale, title=title)
        if show_colorbar:
            self.fig.colorbar(img, ax=ax)
        if axis_option is not None:
            ax.axis(axis_option)
        return ax

    def add_wave_data(self, data, samplate=32000, row_idx=None,
                      col_idx=None, title=None):
        """Render a waveform into a grid cell (``plot.py:126``)."""
        from audioflux_torch.display.display import fill_wave
        return fill_wave(data, samplate=samplate,
                         axes=self._pick(row_idx, col_idx), title=title)

    def add_plot(self, x, y, label="", row_idx=None, col_idx=None,
                 is_legend=True, *, x_lims=None, y_lims=None,
                 y_blank_threshold=0.15, title=None):
        """Render a labeled line into a grid cell (``plot.py:152``)."""
        from audioflux_torch.display.display import fill_plot
        return fill_plot(x, y, axes=self._pick(row_idx, col_idx),
                         label=label, is_legend=is_legend, x_lims=x_lims,
                         y_lims=y_lims, y_blank_threshold=y_blank_threshold,
                         title=title)

    def add_plot_data(self, y, x=None, label=None, title=None):
        """Sequential-cell convenience form of :meth:`add_plot`."""
        from audioflux_torch.display.display import _host
        y = _host(y)
        if x is None:
            x = np.arange(y.shape[-1])
        return self.add_plot(x, y, label=label or "", title=title)

    def show(self):
        import matplotlib.pyplot as plt
        plt.show()

    def save(self, path, dpi=100, **kwargs):
        """Save the figure (accepts any `matplotlib savefig` kwargs)."""
        kwargs.setdefault("bbox_inches", "tight")
        self.fig.savefig(path, dpi=dpi, **kwargs)

    def close(self, fig="all"):
        """Close figure window(s) (``plot.py:219``): None = current,
        'all', a number, a name, or a Figure instance."""
        import matplotlib.pyplot as plt
        plt.close(fig)
