"""FFP pitch — STFT-peak pitch with candidate filtering and resolution.

Counterpart of ``audioflux_tpu/mir/pitch_ffp.py``.  The FFT runs on the
plan's device; the chains and the resolution run on the host.

Reference ``src/mir/_pitch_ffp.c`` + ``src/mir/_queue.c`` + ``_trist3.c``:
per-frame STFT peaks run through the height/near/dB/relation filter chain
and the preprocess/fast/cut chains, and the resulting three candidate sets
are resolved by the trist3 cascade over the six-strategy _queue engine.
All stages are exact ports (``mir/_ffp_chain.py``, ``mir/_queue_util.py``,
``mir/_queue_cut.py``), verified frame-exact against the C object
(tests/test_ffp_chain.py).
"""

from __future__ import annotations

import numpy as np

from audioflux_torch.mir._ffp_chain import FFPChain
from audioflux_torch.ops.backend import host_f32
from audioflux_torch.types import WindowType

__all__ = ["PitchFFP"]


class PitchFFP:
    """API mirrors ``python/audioflux/mir/pitch_ffp.py``, plus ``device``
    (``None`` means ``cuda``).  The FFT runs on the plan's device, the
    per-frame chains and their resolution on the host."""

    def __init__(self, samplate=32000, low_fre=32.0, high_fre=2000.0,
                 radix2_exp=12, slide_length=1024,
                 window_type=WindowType.HAMM, device=None):
        self.samplate = samplate
        self.low_fre = float(low_fre)
        self.high_fre = float(high_fre)
        self.radix2_exp = radix2_exp
        self.fft_length = 1 << radix2_exp
        self.slide_length = slide_length if slide_length else self.fft_length // 4
        self.window_type = WindowType(window_type)
        # the C pitchFFPObj clamps its analysis band to [27, 4000] and only
        # honours lowFre >= 27 / highFre < samplate/2 (pitchFFPObj_new)
        lo = low_fre if low_fre >= 27 else 27.0
        hi = high_fre if (high_fre > lo and high_fre < samplate / 2) else 4000.0
        if not (high_fre > lo and high_fre < samplate / 2):
            lo = 27.0
        self._chain = FFPChain(samplate=samplate, low_fre=lo, high_fre=hi,
                               radix2_exp=radix2_exp,
                               slide_length=self.slide_length,
                               window_type=self.window_type,
                               device=device)
        self.device = self._chain.device

    def cal_time_length(self, data_length: int) -> int:
        return self._chain.cal_time_length(data_length)

    def _pack_rows(self, rows, width):
        """Pack per-frame candidate rows the way the C getters lay them
        out (pitch_ffp.py:215-278): (width, time) fre/db/height planes
        after the wrapper's transpose, plus a (time,) length vector."""
        T = len(rows)
        corr = np.zeros((T, width), np.float32)
        db = np.zeros((T, width), np.float32)
        hei = np.zeros((T, width), np.float32)
        ln = np.zeros(T, np.int32)
        for i, r in enumerate(rows):
            k = min(len(r), width)
            corr[i, :k] = np.float32(r.fre[:k])
            db[i, :k] = np.float32(r.db[:k])
            hei[i, :k] = np.float32(r.h[:k])
            ln[i] = len(r)
        return (np.ascontiguousarray(corr.T), np.ascontiguousarray(db.T),
                np.ascontiguousarray(hei.T), ln)

    def pitch(self, data_arr, has_corr_data=False, has_cut_data=False,
              has_flag_data=False, has_light_data=False,
              has_temporal_data=False):
        """(n,) -> (fre_arr, db_arr) per frame, matching the C
        ``pitchFFPObj_pitch`` frame-exact.

        With any ``has_*_data`` flag set, additionally returns the
        reference's ``extra_data_dic`` (pitch_ffp.py:369-586): tuples of
        candidate/flag/light/temporal arrays keyed ``corr_data``
        (fre/db/height planes + per-frame lengths), ``cut_data`` (first 4
        columns of the same), ``flag_data`` (the trist3 success types),
        ``light_data`` and ``temporal_data`` (avg/max/percent).
        """
        x = host_f32(data_arr)
        fre_arr, db_arr = self._chain.pitch(x)
        if not (has_corr_data or has_cut_data or has_flag_data
                or has_light_data or has_temporal_data):
            return fre_arr, db_arr
        extra = {}
        if has_corr_data:
            extra["corr_data"] = self._pack_rows(
                self._chain.filter3, self._chain.peak_length)
        if has_cut_data:
            extra["cut_data"] = self._pack_rows(self._chain.fast4, 4)
        if has_flag_data:
            extra["flag_data"] = (np.asarray(self._chain.success_flags,
                                             np.int32),)
        if has_light_data:
            extra["light_data"] = (np.asarray(self._chain.light,
                                              np.float32),)
        if has_temporal_data:
            extra["temporal_data"] = self.get_temporal_data()
        return fre_arr, db_arr, extra

    # -- introspection mirroring the C getters --------------------------
    def get_corr_data(self):
        """Level-1 (filter-chain) candidate rows (pitchFFPObj_getCorrData)."""
        return self._chain.filter3

    def get_cut_data(self):
        """Level-3 (cut) candidate rows (pitchFFPObj_getCutData)."""
        return self._chain.fast4

    def get_light_data(self):
        return np.asarray(self._chain.light, np.float32)

    def set_temp_base(self, temp_base: float):
        """pitchFFPObj_setTempBase (affects get_temporal_data percent)."""
        self._chain.temp_base = float(temp_base)

    def get_temporal_data(self):
        """(avg, max, percent) per frame (pitchFFPObj_getTemporalData)."""
        c = self._chain
        return (np.asarray(c.temporal_avg, np.float32),
                np.asarray(c.temporal_max, np.float32),
                np.asarray(c.temporal_percent, np.float32))
