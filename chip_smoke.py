"""End-to-end check of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no result line is printed then):

0. card identity (nvidia-smi name and power limit, torch and CUDA
   versions; sm_90 required; fp32 matmuls must not use TF32);
1. build every kernel from ``audioflux_torch/csrc`` with nvcc (one process
   per source, started together) and print ptxas' register, stack and
   spill lines (the register-resident autocorrelation, the unwrap's
   run-per-thread kernels, the FFT's real-row kernels, its clusters and
   its complex-row kernels must have neither stack nor spill), and the
   FMNMX instructions of each median network kernel beside the network's
   own count;
2. each kernel against its plain PyTorch version on the card: the forward
   and inverse FFT and the fused autocorrelation at every n in
   2048..32768, and the FFT's and the autocorrelation's register routes
   (n = 2048, 4096) on 1, 3 and 65 rows, real, complex and inverse, at an
   offset of one float; the FFT's real-row route (n = 8192, 16384, 32768)
   on 1, 3, 64, 1000, 2113 and 7,472 real rows, aligned and one float off,
   the forward of whole rows and of live spans at an offset (n/8 at 0,
   n/4 at 932, an odd offset and length, five samples at the end) at bins
   1, n/2 + 1, 10,001 and n, the inverse to real output of whole and half
   spectra, of Hermitian spectra, the round trip and a real spectrum
   through the C entry, none of them on a complex-row route; the routes
   of slice 14: complex rows at 32768 (the two-block clusters: forward,
   inverse, a real spectrum's inverse through the C entry) on 1, 3 and
   7,472 rows, aligned and one float off, the general autocorrelation at
   8192 and 16384 (registers) and 32768 (clusters) on the same, and the
   frames entry at n 4096, 8192 and 16384 on NCF's and HarmonicRatio's
   frames and lags (contiguous and ``unfold`` views), at lag 1 and every
   lag, odd frame lengths and one float off, each call's route held by
   its counter; the route of slice 15: complex rows at 8192 and 16384
   (``row_reg_kernel``: the forward, the forward with its stores through
   the transpose buffer, the inverse, a real spectrum's inverse through
   the C entry) on 1, 3, 2113 and 7,472 rows, aligned and one float off,
   each call's route held by its counter; YIN's autocorrelation entry on
   clips of odd
   length, a view at an offset of one float, slides that put frames off
   16-byte alignment, one-frame clips and several lags; the
   fused mel+MFCC kernel over eight shape classes, unaligned views, a
   batch whose tiles do not divide over the persistent blocks, one-frame
   clips and a dense filterbank; the median kernel (``torch.equal``) over
   orders 3..33, its networks at runs of 4, 8 and 16 outputs a thread,
   negatives, +-inf, ties, rows shorter than a run and than the order,
   inner widths that are no multiple of 32 and both axes;
   ``cwt_ifft_bank`` at N = 16384..131072 (``det`` both ways, padded,
   ``pad = 0`` and an odd slice, with and without the support rows, a PWT
   bank, 1, 7 and resident + 1 band-rows, both block sizes, an output at
   an 8-byte address; 1e-5 of the peak); ``unwrap_diff`` and
   ``columnar_scatter`` (``torch.equal``) over phases, index patterns and
   odd shapes, rows no multiple of 4 long among them; ``synsq_bins``
   (``torch.equal``, its count of differing cells printed) over the three
   scale kinds, with and without a threshold; the fused kernel at config
   1's shape (n_fft 1024, 513 bands, slide 256, cc 1) at 1e-5,
   ``fft_pow2`` at n 4096 on the reassignment rows' shape at 5e-5, and
   the resampler on the card against the CPU at 1e-5 of the peak (which a
   TF32 product fails); and (2e) the FFT kernels over ST's whole batch of
   inverse rows (64 x 2048 rows of 4096, forward and inverse) and Deep's
   7,472 frames at 5e-5; and (2f) over slice 9's rows of config 5's 8 x
   30 s (7,472 frames): ``fft_autocorr`` at 8192 on NCF's and
   HarmonicRatio's operands (the general entry), ``fft_pow2`` at 32768 on HPS's frames (4,096
   live samples, the bins it keeps) and PEF's log-grid power (8,192 live at
   its pad, the half spectrum: the real-row route) and on its whole
   product spectrum (complex: the cluster route, on no main path),
   ``fft_inv`` at 32768 on the half product (the real-row route, PEF's
   call), on the whole product to real output and to complex output
   (clusters), and ``fft_pow2`` at 8192 on PEF's frames (4,096 live, the
   bins its rfft keeps), at 5e-5; then ``PitchHPS``, ``PitchLHS``,
   ``PitchPEF`` and ``xcorr`` must launch the real-row route with a live
   span (PEF and xcorr the half-spectrum inverse too) and never a
   complex-row route;
3. the main paths at full size, each with the launch counts set to 0 just
   before it and read just after (on the MIR path, before and after each
   user's call; the route counts show the FFT's register route and the
   median networks; 3c runs after 4b, when the MIR path's tensors are
   freed):
   a. mel+MFCC: ``MelSpectrogram(num=128, samplate=32000, radix2_exp=11,
      slide_length=512).spectrogram_mfcc_fused`` on 1000 clips of T=1000
      frames and on 1000 clips of 4096 samples (T=5), and
      ``.spectrogram()``, gated against ``.spectrogram()`` on the CPU at
      1e-4 of the peak and against the plain versions on the card;
   b. MIR: 64 clips of 30 s at 32 kHz through ``HPSS(radix2_exp=11, HAMM,
      slide_length=512, h_order=21, p_order=31).hpss``,
      ``PitchYIN(samplate=32000, radix2_exp=12, slide_length=1024).pitch``
      and ``STFT(radix2_exp=11, HANN, 512).stft`` -> ``.istft``; every
      kernel's whole-batch output against its plain version on the card,
      and the first and last clips against the port on the CPU;
   c. wavelet: ``CWT(num=84, radix2_exp=15, MORLET, OCTAVE).cwt`` ->
      ``Synsq(num=84, radix2_exp=15).synsq`` on 16 and on 128 noise clips
      of 32768 samples, ``WSST.wsst`` and ``PWT.pwt`` on 16; the wavelet
      kernels' whole-batch outputs against their plain versions (the bare
      unwrap over all 10,752 rows and ``synsq_bins`` over every cell, bit
      for bit, its count of differing cells printed), the kernel path against
      ``force_xla_unwrap=True`` (bin flips and mass), and the first and
      last clips against the port on the CPU;
   d. the reference benchmark's configurations 1, 3 and 5
      (``bench.py:264-334, 356-377, 440-499``): ``BFT(num=513,
      radix2_exp=10, slide_length=256, LINEAR, POWER).bft_fused(x,
      cc_num=1)`` on 128 and 1024 clips of 10 s (against the exact
      ``.bft()`` on the card and the CPU at 1e-4 of the peak, the fused
      kernel against its plain version over both batches at 1e-5); on
      1000 clips of 4096 samples ``abs(CQT(num=84, slide_length=1024).cqt)``
      and ``chroma_linear`` (against the CPU at 1e-4) and the reassigned
      ``BFT(num=128, radix2_exp=12, slide_length=1024)`` (the benchmark's
      gate against the CPU: cells off by 1e-3 of the peak <= 5e-3 of all,
      mass within 1e-4); ``Reassign(radix2_exp=12, slide_length=1024)
      .reassign`` then ``abs`` on 8 clips of 30 s (the same gate); the
      whole config 5 pipeline on 8 clips of 30 s (YIN, the mel
      ``.spectrogram()`` -> ``Spectral.flux`` envelope against the CPU at
      1e-4, the host peak-pick's onset frames against the CPU's, HPSS and
      YIN by 3b's gates); ``CQT(num=24)``, whose top-octave FFT of 16384
      runs the FFT kernel (against the CPU at 1e-4); ``fft_pow2`` over the
      whole server and long reassignment rows against its plain version;
   e. slice 8 (after 4d): ``FeatureExtractor`` with its nine transforms
      (``bft, nsgt, cwt, pwt, cqt, st, fst, dwt, wpt``, radix2_exp 12) on
      64 clips of 4096 samples, each transform alone (ST must launch the
      FFT forward and inverse, FST and NSGT the forward), then
      ``spectral(flux)``, ``xxcc`` (13 coefficients; DWT's 11 bands take
      11) and ``deconv`` on the first 8 clips' results; ``SWT``;
      ``DeepSpectrogram(num=84)`` orders 1 and 4, ``DeepChromaSpectrogram``
      and ``Cepstrogram`` (which launches no kernel) on config 5's 8 clips
      of 30 s; ``hilbert``, ``xcorr`` and ``czt`` on config 3's 1000 clips
      of 4096 samples (each launches the forward and the inverse; ``czt``
      both on the complex-row route at 8192, as the extractor's CWT and
      PWT their inverse) and
      ``phase_vocoder`` on an ``STFT(2048, HANN, 512)`` of the 8 clips; the
      first and last clips against the port on the CPU (FFT-based outputs
      at 1e-4 of the peak, DWT/WPT/SWT at 1e-5, Deep by flips and mass,
      the phase vocoder's magnitudes at 1e-4 with its complex error
      printed, xxcc at 1e-3, deconv's pitch against float64 within 4x the
      CPU's own float32 error); each call's peak device memory printed
      beside the bytes reckoned for it and held under 60 GB;
   f. slice 9 (after 4e): ``PitchNCF``, ``PitchCEP`` (which launches no
      kernel), ``PitchHPS``, ``PitchLHS``, ``PitchPEF``,
      ``HarmonicRatio``, ``TimeStretch`` at rates 0.5 and 1.25 and
      ``PitchShift`` at +2, -5 and +7 semitones on config 5's 8 x 30 s;
      ``PitchSTFT``, ``PitchFFP``, ``Harmonic``, ``TuneTrack`` and
      ``HPSSNMF`` on its first clip; ``nmf`` (k 16) on HPSSNMF's
      magnitude, an ``HMM(16, 64)`` trained on 16 steps and decoded, and
      ``viterbi`` (log domain) over 7,472 steps; NCF and HarmonicRatio
      must launch ``fft_autocorr_frames`` and not the general entry, HPS,
      LHS and PEF the FFT's real-row route with a live span (PEF its
      half-spectrum inverse too) and no complex-row route, TuneTrack
      ``fft_autocorr_yin`` and (its HarmonicRatio) the frames entry; each against
      the port on the CPU (first and last clip): at most 2% of the frames
      off by more than one step of the engine's grid, HarmonicRatio by
      more than 1e-4, TimeStretch/PitchShift at 1e-3 of the peak,
      HPSSNMF's h + p against its input and its energy split within 0.02
      of the CPU's, NMF's reconstruction within 1.05x the CPU's, HMM at
      1e-4, viterbi's states (2%) and log-probabilities (1e-5 relative);
      each call's peak device memory printed beside its reckoning;
   g. slice 10, the parallel family on a (data 2, time 4) mesh (eight
      distinct cards where the machine has them, else its cards cycled:
      on one H100 every shard on cuda:0; the device map is printed): the
      headline mel+MFCC fused per time shard on 16 recordings of 30 min,
      then plain, and the spectral statistics of its output; config 5's
      STFT -> ISTFT on 8 x 10 min; CWT, cwt_det, PWT, CWT -> Synsq and
      WSST band-sharded on 16 noise clips of 2^15 and ccwt on 2 x 2^20;
      ST, FST, NSGT and cst at slice 8's widths and config 3's CQT; HPSS
      and YIN through the batch map on 64 x 30 s; the headline chain in
      four pipeline stages; BatchRunner over 16 WAV files (files against
      arrays, and a resumed run that does each file once); two processes
      of ``parallel.distributed`` (NCCL with a card each, else gloo on
      one card; the script says which) against one; the dry run.  Each
      call's counts are set to 0 before it and read after it, and every
      kernel of the call must have launched at least once a shard; gates:
      equal to the unsharded call on the card, or within 1e-5 of the peak
      with the differing cells counted (synsq and WSST by flips and mass;
      ST, NSGT, cst, CQT at tests/test_sharded_full.py's tolerances), the
      headline's first and last recordings against the CPU at 1e-4;
      then (3g j, slice 12) every sharded function again with
      ``keep_sharded=True`` on the same mesh and inputs: each part on its
      mesh device and ``gather()`` ``torch.equal`` to the default call
      (Synsq's and WSST's reduce-scatter among them); the chains STFT ->
      ISTFT and spectrogram -> spectral stats on ShardedTensors with every
      ``Assembler.put`` and ``gather`` counted (none may run), against the
      gathered chains; ``global_from_local(keep_sharded=True)`` into the
      STFT; the frame-sharded CQT (``mode="gspmd"``) on one 10-min clip
      at 1e-5 of the peak of ``CQT.cqt``;
4. timing with CUDA events: each kernel's entries, their plain versions
   and the library yardsticks at the main paths' shapes, the splits of
   ``PitchYIN.pitch`` and ``Synsq.synsq``, the fused kernel,
   ``cwt_ifft_bank`` and the FFT's register route cut after each stage
   (their splits), the median at runs of 4, 8 and 16 and cut after its
   loads and stores, its bound from a probe of the min/max issue rate,
   ``cwt_ifft_bank`` at both cluster sizes and at half and twice the
   resident grid, the fused kernel at config 1's shape and ``fft_pow2``
   at n 4096 on the reassignment rows (their rows in the kernels line
   list these under ``shapes``), config 5's device part and its host
   stage (host clock) apart, and audio-hours per second of the users'
   calls; the extractor whole and each of its transforms, ``ST.st``, Deep,
   Cepstrogram and the DSP calls (4e), with ``fft_pow2`` and ``fft_inv``
   at slice 8's shapes (ST's 131,072 inverse rows both ways, Deep's
   frames, Hilbert's rows, and xcorr's rows as ``xcorr`` calls them: a
   real forward of the live samples to the half spectrum and the inverse
   of the half product) listed under ``shapes``;
   slice 9 (4f): audio-hours per second of each batched call, the
   host-clock ms of the single-clip calls, NMF, HMM and viterbi (its
   microseconds a step), the splits of NCF, PEF, FFP and HPSSNMF, and the
   FFT kernels at slice 9's shapes as the engines call them (HPS's forward
   of its live frames at the bins it keeps, PEF's frames through rfft,
   PEF's live log-grid power to the half spectrum and the inverse of its
   half product, each with its cuts under ``cuts_ms``; the whole product's
   real and complex inverses and the complex rows on the cluster route
   beside them; the autocorrelation's general entry on NCF's and
   HarmonicRatio's operands, its frames entry on their frames and lags,
   the general entry at 16384 and 32768, and the complex rows at 8192 and
   16384, the row route, on 7,472 random rows, with its cuts under
   ``cuts_ms``: the load and store alone, and the forward's stores
   through the transpose buffer against those from registers) under
   ``shapes`` of ``fft_pow2``, ``fft_inv`` and ``fft_autocorr`` (whose row
   counts every entry's launches), with ``torch.fft.rfft``/``irfft``
   beside the library call where they give the same values; slice 10
   (4g): audio-hours per second of the sharded calls beside the same
   calls unsharded on the same card, the halo bytes and the time of the
   split with its block copies, BatchRunner's files per second (host
   clock) with the loader's time apart, and the kernels at one shard's
   shapes under ``shapes``; slice 12 (4g j): each call default against
   kept, the peak device memory of ccwt and cst in both modes, and the
   CQT on one 10-min clip in the batch form, the frame form and
   unsharded.

The FFT rows of the kernels line carry ``real_route_launches``,
``row_route_launches`` and ``cluster_route_launches``, the shares of
their main-path launches that took the real-row route, the complex rows
at 8192-16384 and the complex rows at 32768.  Config 3's reassigned BFT
(3d) is gated by ``reassign_edge_gate``: flips only where a source cell
lies within float32 rounding of a bin edge, mass over the cells no edge
touches (``tools/reassign_gate_probe.py`` runs it over many draws).  The second-to-last
line is the kernels JSON object; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
``--upto N`` stops after phase N (a development aid: no result lines).
``--s10-worker RANK PORT OUT`` is one process of phase 3g's two-process
call (the script starts both itself).
"""

from __future__ import annotations

import contextlib
import importlib
import json
import math
import os
import shutil
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

from audioflux_torch.classic import HMM, nmf, viterbi  # noqa: E402
from audioflux_torch.core import chroma_linear  # noqa: E402
from audioflux_torch.dsp import czt, hilbert, phase_vocoder, xcorr  # noqa: E402
from audioflux_torch.dsp.resample import Resample  # noqa: E402
from audioflux_torch.features.deconv import Deconv  # noqa: E402
from audioflux_torch.features.extractor import FeatureExtractor  # noqa: E402
from audioflux_torch.features.spectral import Spectral  # noqa: E402
from audioflux_torch.mir import (  # noqa: E402
    HPSS, HPSSNMF, Harmonic, HarmonicRatio, PitchCEP, PitchFFP, PitchHPS,
    PitchLHS, PitchNCF, PitchPEF, PitchShift, PitchSTFT, PitchYIN,
    TimeStretch)
from audioflux_torch.mir.pitch import autocorr_operands  # noqa: E402
from audioflux_torch.mir.onset import (NoveltyParam, Onset,  # noqa: E402
                                       peak_pick)
from audioflux_torch.filterbank.auditory import (  # noqa: E402
    auditory_filter_bank)
from audioflux_torch.io.wave import read as wave_read  # noqa: E402
from audioflux_torch.io.wave import write as wave_write  # noqa: E402
from audioflux_torch.observe import metrics  # noqa: E402
from audioflux_torch.parallel import (  # noqa: E402
    BatchRunner, distributed, make_mesh, pipeline_chain_fn,
    sharded_batch_map_fn, sharded_ccwt_fn, sharded_cqt_fn, sharded_cst_fn,
    sharded_cwt_fn, sharded_fst_fn, sharded_istft_fn, sharded_nsgt_fn,
    sharded_pwt_fn, sharded_spectral_stats_fn, sharded_spectrogram_fn,
    sharded_st_fn, sharded_stft_fn, sharded_synsq_fn, sharded_wsst_fn)
from audioflux_torch.parallel import ShardedTensor, _shard  # noqa: E402
from audioflux_torch.parallel import sharded_full as sharded_full_mod  # noqa: E402,E501
from audioflux_torch.parallel.dryrun import dryrun_multichip  # noqa: E402
from audioflux_torch.parallel.sharded import _time_blocks  # noqa: E402
from audioflux_torch.ops import _build  # noqa: E402
from audioflux_torch.ops import cuda_cwt, cuda_fft, cuda_median  # noqa: E402
from audioflux_torch.ops import median_network  # noqa: E402
from audioflux_torch.ops.cuda_cwt import (band_row_counts,  # noqa: E402
                                          cluster_plan, cwt_ifft_bank,
                                          cwt_ifft_bank_ref,
                                          resident_clusters)
from audioflux_torch.ops.cuda_fft import (  # noqa: E402
    fft_autocorr, fft_autocorr_frames, fft_autocorr_frames_ref,
    fft_autocorr_ref, fft_autocorr_yin, fft_autocorr_yin_ref, fft_fwd,
    fft_fwd_ref, fft_inv, fft_inv_ref)
from audioflux_torch.ops.cuda_median import (  # noqa: E402
    median_filter_last_axis, median_filter_last_axis_ref)
from audioflux_torch.ops.cuda_scatter import (  # noqa: E402
    columnar_scatter, columnar_scatter_ref)
from audioflux_torch.ops.cuda_unwrap import (  # noqa: E402
    bin_map, synsq_bins, synsq_bins_ref, unwrap_diff, unwrap_diff_ref)
from audioflux_torch.ops.fft import rfft  # noqa: E402
from audioflux_torch.ops.fused_mel import (FusedMelPlan,  # noqa: E402
                                           _launch, fused_mel_mfcc,
                                           fused_mel_mfcc_ref)
from audioflux_torch.transforms.spectrogram import (  # noqa: E402
    ErbSpectrogram, MelSpectrogram)
from audioflux_torch.transforms.cwt import (CWT,  # noqa: E402
                                            _symmetric_pad)
from audioflux_torch.transforms.deep import (  # noqa: E402
    DeepChromaSpectrogram, DeepSpectrogram)
from audioflux_torch.transforms.dwt import SWT  # noqa: E402
from audioflux_torch.transforms.bft import BFT  # noqa: E402
from audioflux_torch.transforms.cepstrogram import Cepstrogram  # noqa: E402
from audioflux_torch.transforms.cqt import CQT  # noqa: E402
from audioflux_torch.transforms.pwt import PWT  # noqa: E402
from audioflux_torch.transforms.reassign import Reassign  # noqa: E402
from audioflux_torch.transforms.st import ST  # noqa: E402
from audioflux_torch.transforms.stft import STFT  # noqa: E402
from audioflux_torch.transforms.synsq import Synsq  # noqa: E402
from audioflux_torch.transforms.wsst import WSST  # noqa: E402
from audioflux_torch.track import TuneTrack  # noqa: E402
from audioflux_torch.types import (  # noqa: E402
    ResampleQualityType, SpectralDataType, SpectralFilterBankScaleType,
    WaveletContinueType, WindowType)

SR, NUM, R2E, SLIDE, T_HEAD, N_CLIPS, CC = 32000, 128, 11, 512, 1000, 1000, 13
FFT_TOL, FP32_TOL, FAST_TOL, GATE_TOL = 5e-5, 1e-5, 2e-4, 1e-4
# the MIR path: 64 clips of 30 s; HPSS 2048/512 orders 21/31, YIN 4096/1024
MIR_CLIPS, MIR_SECONDS, MIR_SMALL = 64, 30, 8
H_ORDER, P_ORDER, YIN_R2E, YIN_SLIDE = 21, 31, 12, 1024
YIN_TOL, FRE_TOL_HZ, FRE_SHARE = 2e-4, 1e-2, 0.99
FORK_SHORT_CLIP_MS = 0.3646     # the T<8 fork's call, NVIDIA H100 80GB HBM3, 700 W
# the wavelet path: CWT morlet, 84 octave bands, 2^15 samples (padded
# transform length 65536) -> synchrosqueezing; 16 clips and 128 clips
WAV_NUM, WAV_R2E, WAV_CLIPS, WAV_SMALL = 84, 15, 128, 16
WAV_KW = dict(num=WAV_NUM, radix2_exp=WAV_R2E, samplate=SR)
OCTAVE = SpectralFilterBankScaleType.OCTAVE
FLIP_TOL, FLIP_SHARE, MASS_TOL = 1e-5, 5e-3, 1e-4
# config 1 (bench.py:356-377): linear power spectrogram through
# BFT.bft_fused, n_fft 1024, slide 256, 513 bands; the benchmark's 128
# clips of 10 s, and 1024 (1.3 GB in, 2.6 GB out) to fill the card
C1_CLIPS, C1_FULL, C1_SECONDS = 128, 1024, 10
C1_KW = dict(num=513, radix2_exp=10, samplate=SR, slide_length=256,
             window_type=WindowType.HANN,
             scale_type=SpectralFilterBankScaleType.LINEAR,
             data_type=SpectralDataType.POWER)
# config 3 (bench.py:264-334): 1000 server clips of 4096 samples (CQT,
# chroma, reassigned BFT) and 8 recordings of 30 s (reassignment); the
# benchmark's reassignment gate: cells off by 1e-3 of the peak
C3_CLIPS, C3_N, C3_LONG, C3_SECONDS, C3_R2E, C3_SLIDE = 1000, 4096, 8, 30, 12, 1024
RE_FLIP_TOL = 1e-3
# config 5 (bench.py:440-499): YIN + mel flux onsets + HPSS on 8 x 30 s;
# the share of onset frames that may differ from the CPU's
ONSET_SHARE = 0.02
# slice 8: FeatureExtractor's nine transforms at radix2_exp 12 on 64 clips
# of 4096 samples (ST's inverse: 64 x 2048 rows of 4096), deconv on the
# first 8 clips' results; Deep and Cepstrogram on config 5's 8 x 30 s;
# hilbert, xcorr and czt on config 3's 1000 server clips; the phase
# vocoder on config 5's STFT; the phase's device memory limit
FE_NAMES = ("bft", "nsgt", "cwt", "pwt", "cqt", "st", "fst", "dwt", "wpt")
FE_CLIPS, FE_R2E, FE_DECONV, CC_NUM = 64, 12, 8, 13
PV_SLIDE, PV_RATE, MEM_LIMIT_GB = 512, 1.25, 60.0
# slice 9: the batched pitch engines, HarmonicRatio, TimeStretch and
# PitchShift on config 5's 8 x 30 s, the single-signal engines on its first
# clip, NMF (k 16) on HPSSNMF's magnitude, HMM(16, 64) and viterbi over the
# 7,472 frames' count of steps.  Gates against the CPU port: at most 2% of
# the frames (the onset gate's form) may differ by more than one step of
# the engine's own grid (a bin, a lag), HarmonicRatio by more than 1e-4;
# TimeStretch/PitchShift at 1e-3 of the peak (the phase vocoder sums the
# FFT's rounding into each bin's phase over 934 frames); HPSSNMF's h + p
# is the input inside its edges at 1e-3 of the peak, and its harmonic
# energy share within 0.02 of the CPU's; NMF's reconstruction within 1.05x
# the CPU's (tests/test_classic.py's bound).  The unscaled HMM recursions
# (the C's and the JAX package's) underflow float32 after about 20 steps
# at 64 symbols, so HMM trains on 16, for 5 iterations: past about 10, a
# state that 16 steps stop visiting gets 0/0 in its transition row (both
# packages).
S9_SHARE, S9_HR_TOL, S9_TS_TOL, S9_REC_TOL, S9_SPLIT_TOL = (
    0.02, 1e-4, 1e-3, 1e-3, 0.02)
S9_RATES, S9_SHIFTS = (0.5, 1.25), (2, -5, 7)
S9_NMF_K, S9_HMM_S, S9_HMM_N, S9_HMM_T, S9_HMM_ITERS = 16, 16, 64, 16, 5
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12     # H100 SXM data sheet, fp32 outside tensor cores


def phase(msg):
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def rel_err(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max())


def check(name, err, tol):
    print(f"  {name}: max err / peak = {err:.3e} (tol {tol:.0e})", flush=True)
    if not err <= tol:
        raise AssertionError(f"{name}: {err:.3e} > {tol:.0e}")


def pair_err(got, ref):
    """(max abs error, peak of |ref|) of (re, im) pairs; im may be None."""
    err = max(float((g - r).abs().max()) for g, r in zip(got, ref)
              if r is not None)
    sq = sum(r.double() ** 2 for r in ref if r is not None)
    return err, float(sq.max().sqrt())


def cuda_ms(fn, reps=10, warmup=2):
    """Median of ``reps`` CUDA-event timings of ``fn()``, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def bound_ms(n_bytes, n_flops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def randn(shape, gen, scale=1.0):
    return torch.randn(shape, generator=gen, device="cuda",
                       dtype=torch.float32) * scale


def phase0_identity():
    phase("phase 0: card identity")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: chip_smoke.py needs an H100")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"  nvidia-smi: {smi}")
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise SystemExit(f"need an sm_90 card, found capability {cap}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("torch.backends.cuda.matmul.allow_tf32 must be False")
    return smi.splitlines()[0]


# kernels that must compile with no stack frame and no spill (their
# register arrays must stay in registers)
NO_SPILL = ("autocorr_reg_kernel", "unwrap_rows_kernel", "real_fwd_kernel",
            "real_inv_kernel", "acf_reg_kernel", "cluster_kernel",
            "row_reg_kernel")


def phase1_build():
    phase("phase 1: build kernels (nvcc, sm_90a)")
    t0 = time.perf_counter()
    reports = _build.build(verbose=True)
    seconds = time.perf_counter() - t0
    spilled = []
    for name, log in reports.items():
        fn = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                # the mangled name holds the kernel's own name
                print(f"  {name}: {line.split("'")[1]}")
            elif "Function properties for" in line:
                fn = line.split("Function properties for")[1].strip()
            elif "registers" in line or "spill" in line:
                print(f"  {name}:   {line.strip()}")
                if ("stack frame" in line and any(k in fn for k in NO_SPILL)
                        and any(int(w) for w in line.split()
                                if w.isdigit())):
                    spilled.append(f"{fn}: {line.strip()}")
    print(f"  build seconds: {seconds:.2f}")
    if spilled:
        raise AssertionError("stack or spill in " + "; ".join(spilled))
    print(f"  {', '.join(NO_SPILL)}: no stack, no spill")
    network_sass_counts()


def network_sass_counts():
    """The min/max instructions (FMNMX) of each median network kernel in
    the built library, read with cuobjdump, beside the generated network's
    count: the bound's operations are the ones the card runs."""
    cuobjdump = (shutil.which("cuobjdump")
                 or "/usr/local/cuda/bin/cuobjdump")
    if not os.path.exists(cuobjdump):
        print("  cuobjdump not found: FMNMX counts not read")
        return
    sass = subprocess.run(
        [cuobjdump, "-sass", str(_build._lib_path("median_filter"))],
        capture_output=True, text=True, check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = 0
        elif fn is not None and "FMNMX" in line:
            counts[fn] += 1
    for order, m in median_network.INSTANCES:
        want = median_network.build(order, m).minmax
        for kind in ("strided", "rows"):
            got = [c for f, c in counts.items()
                   if f"median_run_{kind}ILi{order}ELi{m}E" in f]
            print(f"  median_filter: median_run_{kind}<{order}, {m}> FMNMX "
                  f"{got[0] if got else 'not found'} (network: {want}; "
                  f"{'equal' if got == [want] else 'differs'})")


def phase2_kernels(gen):
    phase("phase 2: kernels against their plain versions")
    # max |kernel - plain| at the main paths' n, for the kernels line
    errs = {"fft_pow2": 0.0, "fused_mel_mfcc": 0.0, "fft_inv": 0.0,
            "fft_autocorr": 0.0, "fft_autocorr_yin": 0.0,
            "median_filter": 0.0}
    for n in (2048, 4096, 8192, 16384, 32768):
        xr = randn((64, n), gen)
        xi = randn((64, n), gen)
        for label, args in (("real", (xr,)), ("complex", (xr, xi))):
            abs_err, peak = pair_err(fft_fwd(*args), fft_fwd_ref(*args))
            check(f"fft_pow2 n={n} {label}", abs_err / peak, FFT_TOL)
            if n == 1 << R2E:
                errs["fft_pow2"] = max(errs["fft_pow2"], abs_err)
        for out_imag in (True, False):
            got = fft_inv(xr, xi, out_imag=out_imag)
            if (got[1] is None) == out_imag:
                raise AssertionError("fft_inv: wrong imaginary output")
            abs_err, peak = pair_err(got, fft_inv_ref(xr, xi, out_imag))
            check(f"fft_inv n={n} out_imag={out_imag}", abs_err / peak,
                  FFT_TOL)
            if n == 1 << R2E:
                errs["fft_inv"] = max(errs["fft_inv"], abs_err)
        yr, yi = fft_fwd(xr, xi)
        abs_err, peak = pair_err(fft_inv(yr, yi), (xr, xi))
        check(f"fft_inv(fft_fwd(x)) n={n} round trip", abs_err / peak,
              FFT_TOL)
        abs_err, peak = pair_err((fft_autocorr(xr, xi),),
                                 (fft_autocorr_ref(xr, xi),))
        check(f"fft_autocorr n={n}", abs_err / peak, FFT_TOL)
        if n == 1 << YIN_R2E:
            errs["fft_autocorr"] = abs_err
    torch.cuda.synchronize()
    # the register route: real rows in pairs (an odd batch's last row
    # alone), complex rows and the inverse, on rows at an address 16-byte
    # aligned and at an offset of one float
    for n in cuda_fft.REGISTER_N:
        for batch in (1, 3, 65):
            buf = randn(2 * batch * n + 1, gen)
            worst = 0.0
            for off in (0, 1):
                xr = buf[off:off + batch * n].view(batch, n)
                xi = buf[off + batch * n:off + 2 * batch * n].view(batch, n)
                for args in ((xr,), (xr, xi)):
                    abs_err, peak = pair_err(fft_fwd(*args),
                                             fft_fwd_ref(*args))
                    worst = max(worst, abs_err / peak)
                for out_imag in (True, False):
                    abs_err, peak = pair_err(fft_inv(xr, xi, out_imag),
                                             fft_inv_ref(xr, xi, out_imag))
                    worst = max(worst, abs_err / peak)
                # the C entry's inverse of a real spectrum (a null
                # imaginary input), which no wrapper passes
                got = (torch.empty_like(xr), torch.empty_like(xr))
                cuda_fft._call(cuda_fft._lib().af_fft_pow2_inv,
                               "fft_pow2 inverse", xr, n, xr.data_ptr(), None,
                               got[0].data_ptr(), got[1].data_ptr(),
                               extra=(n, 3))
                abs_err, peak = pair_err(
                    got, fft_inv_ref(xr, torch.zeros_like(xr)))
                worst = max(worst, abs_err / peak)
            check(f"fft_pow2 register route n={n}, {batch} rows (real, "
                  "complex, inverse of complex and of real spectra; offsets "
                  "0 and 1 float)", worst, FFT_TOL)
            worst = 0.0
            for off in (0, 1):
                xr = buf[off:off + batch * n].view(batch, n)
                xi = buf[off + batch * n:off + 2 * batch * n].view(batch, n)
                abs_err, peak = pair_err((fft_autocorr(xr, xi),),
                                         (fft_autocorr_ref(xr, xi),))
                worst = max(worst, abs_err / peak)
            check(f"fft_autocorr register route n={n}, {batch} rows "
                  "(offsets 0 and 1 float)", worst, FFT_TOL)
    real_route_kernels(gen)
    errs.update(slice14_kernels())
    row_route_kernels()
    # YIN's entry, framing from the clips: clips whose length is no
    # multiple of the slide (every other clip off 16-byte alignment), a
    # 1-D view at an offset of one float, slides that put frames off
    # alignment, one-frame clips, and lags 0, odd, n/2 and n - 1
    for n in cuda_fft.REGISTER_N:
        h = n // 2
        cases = [("3 clips of odd length", randn((3, 7 * h + 1001), gen),
                  n // 4, h),
                 ("1-D view at offset 1", randn(5 * n + 1, gen)[1:], 1000,
                  1001),
                 ("2 clips, slide 1001", randn((2, 6 * n + 3), gen), 1001,
                  h),
                 ("4 clips of one frame", randn((4, n + 5), gen), n // 4,
                  h),
                 ("65 clips, lags from 0", randn((65, 2 * n), gen), h, 0),
                 ("2 clips, lag n - 1", randn((2, 3 * n), gen), 777, n - 1)]
        for label, x, slide, lag in cases:
            got = fft_autocorr_yin(x, n, slide, lag)
            torch.cuda.synchronize()
            ref = fft_autocorr_yin_ref(x, n, slide, lag)
            if got.shape != ref.shape:
                raise AssertionError(f"fft_autocorr_yin {label}: shape "
                                     f"{tuple(got.shape)}")
            abs_err, peak = pair_err((got,), (ref,))
            check(f"fft_autocorr_yin n={n} {label} (slide {slide}, lag "
                  f"{lag})", abs_err / peak, FFT_TOL)
            if n == 1 << YIN_R2E:
                errs["fft_autocorr_yin"] = max(errs["fft_autocorr_yin"],
                                               abs_err)

    # the median kernel, value for value: network orders (21, 31) at
    # cuda_median.RUN outputs a thread, rank counting (the rest); negatives,
    # +-inf, ties and zeros; rows shorter than a run and than the order,
    # one column, 1-D, inner widths that are no multiple of 32, and the
    # strided axis (dim=-2)
    for shape, dim in (((37, 1025), -1), ((5, 7), -1), ((9, 1), -1),
                       ((1000,), -1), ((7, 3), -1), ((2, 2, 17), -1),
                       ((3, 50, 70), -2), ((2, 129, 1025), -2),
                       ((4, 300, 33), -2), ((3, 5, 4, 3), 1)):
        x = randn(shape, gen)
        x = torch.where(x.abs() < 0.3, torch.zeros_like(x), x)  # ties, zeros
        flat = x.view(-1)
        flat[::17] = math.inf
        flat[5::19] = -math.inf
        for order in (3, 9, 21, 31, 33):
            ref = median_filter_last_axis_ref(x, order, dim)
            got = median_filter_last_axis(x, order, dim)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise AssertionError(
                    f"median {shape} dim={dim} order={order}: "
                    f"{int((got != ref).sum())} cells differ")
        print(f"  median {shape} dim={dim}: orders 3, 9, 33 (rank counting), "
              f"21 and 31 (networks, runs of {cuda_median.RUN}) equal to the "
              "full sort")
    for order in (1, 4):
        if median_filter_last_axis(x, order) is not x:
            raise AssertionError(f"median order {order} must return its input")

    # the headline, then every shape class of the kernel: n_fft 128..16384
    # (one round per tile up to four), odd bands, cosine and plain windows
    configs = [
        ("headline mel128 2048/512 hann", MelSpectrogram, dict(
            num=NUM, radix2_exp=R2E, slide_length=SLIDE), 8, T_HEAD, CC),
        ("erb64 4096/1024 blackman", ErbSpectrogram, dict(
            num=64, radix2_exp=12, slide_length=1024,
            window_type=WindowType.BLACKMAN), 3, 333, 4),
        ("mel32 512/128 hann", MelSpectrogram, dict(
            num=32, radix2_exp=9, slide_length=128), 2, 101, 5),
        ("mel64 1024/256 hamm", MelSpectrogram, dict(
            num=64, radix2_exp=10, slide_length=256,
            window_type=WindowType.HAMM), 2, 57, 13),
        ("mel64 2048/2048 rect", MelSpectrogram, dict(
            num=64, radix2_exp=11, slide_length=2048,
            window_type=WindowType.RECT), 2, 17, 5),
        ("mel24 128/128 hann", MelSpectrogram, dict(
            num=24, radix2_exp=7, slide_length=128), 2, 40, 5),
        ("mel128 8192/2048 hann", MelSpectrogram, dict(
            num=128, radix2_exp=13, slide_length=2048), 2, 30, 13),
        ("mel256 16384/4096 hann", MelSpectrogram, dict(
            num=256, radix2_exp=14, slide_length=4096), 2, 21, 20),
    ]
    for label, cls, kw, batch, T, cc_num in configs:
        sp = cls(samplate=SR, device="cuda", **kw)
        plan = FusedMelPlan(sp.window, sp.filter_bank, sp._dct[:cc_num],
                            sp.slide_length, device="cuda")
        x = randn((batch, (T - 1) * sp.slide_length + sp.fft_length), gen, 0.2)
        mel_r, cc_r = fused_mel_mfcc_ref(plan, x)
        for fast, tol in ((False, FP32_TOL), (True, FAST_TOL)):
            mel, cc = fused_mel_mfcc(plan, x, fast=fast)
            torch.cuda.synchronize()
            if mel.shape != mel_r.shape or cc.shape != cc_r.shape:
                raise AssertionError(f"{label}: shape {tuple(mel.shape)}")
            for what, a, b in (("mel", mel, mel_r), ("cc", cc, cc_r)):
                check(f"fused {label} fast={fast} {what}", rel_err(a, b),
                      tol)
                if not fast and label.startswith("headline"):
                    errs["fused_mel_mfcc"] = max(
                        errs["fused_mel_mfcc"],
                        float((a - b).abs().max()))

    # inputs at addresses that are not 16-byte aligned: a 1-D clip viewed
    # at an offset of one sample, and clips of odd length (every other
    # clip starts off alignment)
    sp = MelSpectrogram(num=NUM, samplate=SR, radix2_exp=R2E,
                        slide_length=SLIDE, device="cuda")
    plan = FusedMelPlan(sp.window, sp.filter_bank, sp._dct[:CC], SLIDE,
                        device="cuda")
    n = (40 - 1) * SLIDE + sp.fft_length
    for label, x in (("1-D view at offset 1", randn(n + 1, gen, 0.2)[1:]),
                     ("4 clips of odd length", randn((4, n + 1), gen, 0.2))):
        mel, cc = fused_mel_mfcc(plan, x)
        torch.cuda.synchronize()
        mel_r, cc_r = fused_mel_mfcc_ref(plan, x.clone())
        for what, a, b in (("mel", mel, mel_r), ("cc", cc, cc_r)):
            check(f"fused {label} {what}", rel_err(a, b), FP32_TOL)
    # a batch whose tiles are no multiple of what a persistent block walks
    # (blocks cross clip boundaries mid-way), clips of one frame, and a
    # dense (all-nonzero) filterbank, whose weights do not fit shared memory
    fb = randn((NUM, sp.fft_length // 2 + 1), gen).abs() + 0.01
    dense = FusedMelPlan(sp.window, fb.cpu().numpy(), sp._dct[:CC], SLIDE,
                         device="cuda")
    for label, pl, x in (
            ("150 clips of T=37", plan, randn((150, 36 * SLIDE + 2048), gen, 0.2)),
            ("3 clips of one frame", plan, randn((3, 2048), gen, 0.2)),
            ("one clip of T=3", plan, randn((1, 2 * SLIDE + 2048 + 77), gen, 0.2)),
            ("dense filterbank, 5 clips of T=41", dense,
             randn((5, 40 * SLIDE + 2048), gen, 0.2))):
        mel, cc = fused_mel_mfcc(pl, x)
        torch.cuda.synchronize()
        mel_r, cc_r = fused_mel_mfcc_ref(pl, x)
        for what, a, b in (("mel", mel, mel_r), ("cc", cc, cc_r)):
            check(f"fused {label} {what}", rel_err(a, b), FP32_TOL)
    return errs


def real_route_kernels(gen):
    """The real-row route (n = 8192..32768) against the plain versions, at
    5e-5 of the whole spectrum's peak: 1, 3, 64, 1000, 2113 (odd, and more
    than two rows a resident block at every n) and 7,472 rows, at a 16-byte
    aligned address and one float off (the rows whose every address is
    16-byte aligned take the TMA bulk copy, the others cp.async; whole rows
    at 32768 are read without staging); the forward of whole rows and of
    live spans at offset lo (HPS's n/8 at 0, PEF's n/4 at 932, an odd
    offset with a length no multiple of 16, five samples at the end) at
    bins 1, n/2 + 1, 10,001 and n (n/2 + 1 and n from 1000 rows on); the
    inverse to real output of random whole spectra and of half spectra;
    below 1000 rows also of Hermitian spectra (a real row's), the round
    trip, and the C entry's inverse of a real spectrum (a null imaginary
    input) into an output one float off.  Every call must take the
    real-row route, none a complex-row route."""
    # the inputs of 1, 3 and 64 rows come from the shared generator, as
    # before this route had live spans and half spectra (the later phases'
    # inputs follow from its state); every other input from one of this
    # phase's own
    own = torch.Generator(device="cuda")
    own.manual_seed(13)
    for n in (8192, 16384, 32768):
        N = n // 2
        spans = ((0, n), (0, n // 8), (932, n // 4), (931, n // 4 - 5),
                 (n - 5, 5))
        for batch in (1, 3, 64, 1000, 2113, 7472):
            big = batch >= 1000
            bins_list = ((N + 1, n) if big
                         else sorted({1, N + 1, min(10001, n), n}))
            worst = 0.0
            zero_counts()
            yb = randn(2 * batch * n + 2, own if big else gen)
            for off in (0, 1):
                for lo, live in spans:
                    buf = (yb if live == n and not big
                           else randn(batch * live + 2, own))
                    x = buf[off:off + batch * live].view(batch, live)
                    full = fft_fwd_ref(x, None, n, n, lo)
                    peak = pair_err(full, full)[1]
                    del full
                    for bins in bins_list:
                        e, _ = pair_err(fft_fwd(x, bins=bins, n=n, lo=lo),
                                        fft_fwd_ref(x, None, bins, n, lo))
                        worst = max(worst, e / peak)
                    del buf, x
                yr = yb[off:off + batch * n].view(batch, n)
                yi = yb[off + batch * n:off + 2 * batch * n].view(batch, n)
                worst = max(worst, pair_rel(
                    fft_inv(yr, yi, out_imag=False),
                    fft_inv_ref(yr, yi, out_imag=False)))
                m = N + 1
                hr = yb[off:off + batch * m].view(batch, m)
                hi = yb[off + batch * m:off + 2 * batch * m].view(batch, m)
                worst = max(worst, pair_rel(fft_inv(hr, hi, n=n),
                                            fft_inv_ref(hr, hi, n=n)))
                if not big:
                    xr = yr
                    full = fft_fwd_ref(xr)
                    worst = max(worst, pair_rel(
                        fft_inv(*full, out_imag=False),
                        fft_inv_ref(*full, out_imag=False)))
                    back, _ = fft_inv(*fft_fwd(xr), out_imag=False)
                    worst = max(worst, pair_rel((back,), (xr,)))
                    out = torch.empty(batch * n + 1, device="cuda")[1:].view(
                        batch, n)
                    cuda_fft._call(cuda_fft._lib().af_fft_pow2_inv,
                                   "fft_pow2 inverse", xr, n, xr.data_ptr(),
                                   None, out.data_ptr(), None, extra=(n, 3))
                    worst = max(worst, pair_rel(
                        (out,), fft_inv_ref(xr, torch.zeros_like(xr), False)))
                del yr, yi, hr, hi
            del yb
            torch.cuda.synchronize()
            counts = read_counts()
            for d in ("fft_pow2", "fft_inv"):
                if (counts[f"{d} cluster route"] or counts[f"{d} row route"]
                        or counts[f"{d} real-row route"] != counts[d]):
                    raise AssertionError(f"real rows at n={n} left the "
                                         f"real-row route: {counts}")
            if not counts["fft_pow2 live span"] or not counts[
                    "fft_inv half spectrum"]:
                raise AssertionError(f"n={n}: no live-span forward or half "
                                     f"spectrum inverse: {counts}")
            check(f"fft_pow2 real-row route n={n}, {batch} rows (forward of "
                  f"whole rows and {len(spans) - 1} live spans at bins "
                  f"{list(bins_list)}, inverse to real output of whole and "
                  "half spectra" + ("" if big else ", Hermitian spectra, "
                                    "round trip, a real spectrum through "
                                    "the C entry") + "; offsets 0 and 1 "
                  "float)", worst, FFT_TOL)


def slice14_kernels():
    """The routes redesigned in slice 14 against their plain versions at
    5e-5 of the peak, from a generator of their own (the later phases'
    draws do not move): complex rows at n = 32768 (the two-block
    clusters): the forward, the inverse with an imaginary output, and the
    C entry's inverse of a real spectrum (a null imaginary input), on 1, 3
    and 7,472 rows, at a 16-byte aligned address and one float off (the
    rows then go by cp.async, not TMA); beside them the forward of real
    rows (xi=None) and the inverse without an imaginary output, which take
    the real-row route; the general autocorrelation at 8192 and 16384 (in
    registers) and 32768 (the clusters) on the same rows; the frames entry
    at n 4096, 8192 and 16384 on NCF's and HarmonicRatio's 7,472 frames and
    lags (contiguous, and as ``unfold`` views of clips), at lag 1 and every
    lag, frames no multiple of 4 long and one float off.  Each call's route
    is held by its counter.  Returns the largest absolute errors at the
    main paths' shapes, for the kernels line."""
    own = torch.Generator(device="cuda")
    own.manual_seed(14)
    errs = {}
    n = cuda_fft.CLUSTER_N
    print(f"  the card holds {cuda_fft.resident_clusters(False)} clusters "
          f"of two blocks of the complex rows at {n} at once "
          f"({cuda_fft.resident_clusters(True)} of the autocorrelation's; "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} "
          "SMs)")
    for batch in (1, 3, 7472):
        worst = 0.0
        zero_counts()
        for off in (0, 1):
            buf = randn(2 * batch * n + 1, own)
            xr = buf[off:off + batch * n].view(batch, n)
            xi = buf[off + batch * n:off + 2 * batch * n].view(batch, n)
            worst = max(worst, pair_rel(fft_fwd(xr, xi), fft_fwd_ref(xr, xi)),
                        pair_rel(fft_inv(xr, xi), fft_inv_ref(xr, xi)))
            got = (torch.empty_like(xr), torch.empty_like(xr))
            cuda_fft._call(cuda_fft._lib().af_fft_pow2_inv,
                           "fft_pow2 inverse", xr, n, xr.data_ptr(), None,
                           got[0].data_ptr(), got[1].data_ptr(),
                           extra=(n, 3))
            worst = max(worst, pair_rel(
                got, fft_inv_ref(xr, torch.zeros_like(xr))))
            worst = max(worst, pair_rel(fft_fwd(xr), fft_fwd_ref(xr)),
                        pair_rel(fft_inv(xr, xi, out_imag=False),
                                 fft_inv_ref(xr, xi, out_imag=False)))
            del buf, xr, xi, got
        torch.cuda.synchronize()
        c = read_counts()
        want = {"fft_pow2 cluster route": 2, "fft_inv cluster route": 2,
                "fft_pow2 real-row route": 2, "fft_inv real-row route": 2}
        if any(c[k] != v for k, v in want.items()):
            raise AssertionError(f"cluster route, {batch} rows: routes {c}")
        check(f"fft_pow2/fft_inv cluster route n={n}, {batch} rows (forward, "
              "inverse, the C entry's inverse of a real spectrum; beside "
              "them xi=None and out_imag=False on the real-row route; "
              "offsets 0 and 1 float)", worst, FFT_TOL)
    for n in (8192, 16384, 32768):
        for batch in (1, 3, 7472):
            worst = 0.0
            zero_counts()
            for off in (0, 1):
                buf = randn(2 * batch * n + 1, own)
                xr = buf[off:off + batch * n].view(batch, n)
                xi = buf[off + batch * n:off + 2 * batch * n].view(batch, n)
                e, pk = pair_err((fft_autocorr(xr, xi),),
                                 (fft_autocorr_ref(xr, xi),))
                worst = max(worst, e / pk)
                if batch == 7472:
                    errs[f"acf {n}"] = max(errs.get(f"acf {n}", 0.0), e)
                del buf, xr, xi
            torch.cuda.synchronize()
            c = read_counts()
            if (c["fft_autocorr"] != 2
                    or c["fft_autocorr cluster"] != 2 * (n == 32768)):
                raise AssertionError(f"fft_autocorr n={n}: routes {c}")
            way = "clusters" if n == 32768 else "registers"
            check(f"fft_autocorr n={n} ({way}), {batch} rows (offsets 0 "
                  "and 1 float)", worst, FFT_TOL)
    ncf = PitchNCF(samplate=SR, device="cuda")
    hr = HarmonicRatio(samplate=SR, device="cuda")
    clips = randn((MIR_SMALL, MIR_SECONDS * SR), own, 0.3)
    cases = [(8192, ncf.max_index + 1, 7472, 0, "NCF's lags"),
             (8192, hr.max_length + 1, 7472, 0, "HarmonicRatio's lags"),
             (8192, 1, 65, 0, "lag 1"), (8192, 8192, 65, 1, "every lag"),
             (4096, 4096, 33, 1, "every lag"),
             (16384, 1001, 7472, 1, "1001 lags"),
             (16384, 16384, 3, 0, "every lag")]
    for n, lags, rows, off, label in cases:
        L = n // 2
        for kind in ("contiguous", "unfold", "odd length"):
            if kind == "unfold":
                if rows != 7472:
                    continue
                f = clips.unfold(-1, L, 1024 if n == 8192 else 2 * L // 4)
                f = f[..., :rows // MIR_SMALL, :]
            else:
                Lk = L - 3 if kind == "odd length" else L
                buf = randn(rows * Lk + 1, own)
                f = buf[off:off + rows * Lk].view(rows, Lk)
            zero_counts()
            got = fft_autocorr_frames(f, n, lags)
            torch.cuda.synchronize()
            c = read_counts()
            if c["fft_autocorr_frames"] != 1 or c["fft_autocorr"]:
                raise AssertionError(f"fft_autocorr_frames: routes {c}")
            e, pk = pair_err((got,), (fft_autocorr_frames_ref(f, n, lags),))
            if label.startswith(("NCF", "HarmonicRatio")):
                errs["frames"] = max(errs.get("frames", 0.0), e)
            check(f"fft_autocorr_frames n={n}, {tuple(f.shape)} {kind} "
                  f"frames (offset {off if kind != 'unfold' else 0}), "
                  f"{label} ({lags})", e / pk, FFT_TOL)
            del f, got
    del clips
    return errs


def row_route_kernels():
    """The complex rows at n = 8192 and 16384 (``row_reg_kernel``, slice
    15) against the plain versions at 5e-5 of the peak, from a generator of
    their own (the later phases' draws do not move): the forward, the
    forward with its stores through the transpose buffer (``stages=2``, the
    measurement variant), the inverse with an imaginary output, and the C
    entry's inverse of a real spectrum (a null imaginary input, whose
    plane the kernel leaves at zero), on 1, 3 (odd), 2113 and 7,472 rows
    (no multiple of the resident blocks at either n), at a 16-byte aligned
    address (TMA) and one float off (``cp.async``).  Each wrapper call's
    route is held by its counter."""
    own = torch.Generator(device="cuda")
    own.manual_seed(15)
    for n in (8192, 16384):
        for batch in (1, 3, 2113, 7472):
            worst = 0.0
            zero_counts()
            for off in (0, 1):
                buf = randn(2 * batch * n + 1, own)
                xr = buf[off:off + batch * n].view(batch, n)
                xi = buf[off + batch * n:off + 2 * batch * n].view(batch, n)
                ref = fft_fwd_ref(xr, xi)
                worst = max(worst, pair_rel(fft_fwd(xr, xi), ref),
                            pair_rel(cuda_fft._fwd(xr, xi, n, stages=2), ref))
                del ref
                worst = max(worst, pair_rel(fft_inv(xr, xi),
                                            fft_inv_ref(xr, xi)))
                got = (torch.empty_like(xr), torch.empty_like(xr))
                cuda_fft._call(cuda_fft._lib().af_fft_pow2_inv,
                               "fft_pow2 inverse", xr, n, xr.data_ptr(), None,
                               got[0].data_ptr(), got[1].data_ptr(),
                               extra=(n, 3))
                worst = max(worst, pair_rel(
                    got, fft_inv_ref(xr, torch.zeros_like(xr))))
                del buf, xr, xi, got
            torch.cuda.synchronize()
            c = read_counts()
            want = {"fft_pow2": 4, "fft_pow2 row route": 4, "fft_inv": 2,
                    "fft_inv row route": 2}
            if any(c[k] != v for k, v in want.items()):
                raise AssertionError(f"row route n={n}, {batch} rows: "
                                     f"routes {c}")
            check(f"fft_pow2/fft_inv row route n={n}, {batch} rows (forward, "
                  "forward with its stores through the buffer, inverse, the "
                  "C entry's inverse of a real spectrum; offsets 0 and 1 "
                  "float)", worst, FFT_TOL)


def complex_err(got, ref):
    """(max abs error, peak of |ref|) of two complex tensors."""
    return float((got - ref).abs().max()), float(ref.abs().max())


def wrapped_phases(rows, T, gen):
    """Wrapped phases that stress the unwrap: large random steps (wraps
    both ways, counts far past 2 pi), a slow drift, steady steps next to pi
    (the knife edge) and plain noise."""
    def wrap(t):
        return torch.atan2(torch.sin(t), torch.cos(t))
    u = torch.rand((rows, T), generator=gen, device="cuda")
    j = torch.arange(T, device="cuda", dtype=torch.float32)
    return {"wrapping": wrap(torch.cumsum(u * 5.5 - 2.5, dim=-1)),
            "drifting": wrap(torch.cumsum(0.3 + 0.05 * u, dim=-1)),
            "steady": wrap((3.1 * j).expand(rows, T).contiguous()),
            "noise": (u * 2 - 1) * math.pi}


def synsq_cells(B, T, gen):
    """(B, WAV_NUM, T) complex64 cells for ``synsq_bins``: the band rows
    take the four kinds of wrapped phase in turn (atan2(re, im) gives the
    phase back), magnitudes spread over 1e-4.5 .. 1 around the threshold,
    and every 37th cell exactly 0."""
    rows = B * WAV_NUM
    kinds = wrapped_phases(rows, T, gen)
    ph = torch.stack(list(kinds.values()))[
        torch.arange(rows, device="cuda") % 4, torch.arange(rows,
                                                            device="cuda")]
    mag = 10 ** (torch.rand((rows, T), generator=gen, device="cuda") * 4.5
                 - 4.5)
    mag.view(-1)[::37] = 0
    return torch.complex(mag * torch.sin(ph),
                         mag * torch.cos(ph)).reshape(B, WAV_NUM, T)


def phase2_wavelet_kernels(gen, errs):
    phase("phase 2 (wavelet): kernels against their plain versions")
    # --- cwt_ifft_bank: every N, det both ways, padded / pad = 0 / odd
    # pad and length, with and without the support rows, a PWT bank -------
    for n in (16384, 32768, 65536, 131072):
        F = torch.complex(randn((3, n), gen), randn((3, n), gen))
        bank = torch.zeros((6, n), device="cuda")
        for j, hi in enumerate((40, 300, 700, 1500, n // 8, n // 2)):
            bank[j, 1:hi] = randn((hi - 1,), gen).abs()
        pwt_bank, _, _ = auditory_filter_bank(
            12, n, SR, low_fre=32.703, high_fre=SR / 2.0, scale_type=5,
            is_pseudo=True)
        banks = {"graded": bank, "dense": randn((3, n), gen).abs(),
                 "pwt": torch.from_numpy(pwt_bank).cuda()}
        worst = 0.0
        for label, bk in banks.items():
            rows = torch.tensor(band_row_counts(bk.cpu().numpy(), n),
                                dtype=torch.int32, device="cuda")
            for pad, length in ((n // 4, n // 2), (0, n), (1000, 12345)):
                for det in (False, True):
                    ref = cwt_ifft_bank_ref(F, bk, pad=pad, length=length,
                                            det=det)
                    for row_h in (None, rows):
                        got = cwt_ifft_bank(F, bk, pad=pad, length=length,
                                            det=det, row_h=row_h)
                        torch.cuda.synchronize()
                        e, pk = complex_err(got, ref)
                        worst = max(worst, e / pk)
                        if not e / pk <= FP32_TOL:
                            raise AssertionError(
                                f"cwt_ifft_bank n={n} {label} pad={pad} "
                                f"length={length} det={det} row_h="
                                f"{row_h is not None}: {e / pk:.3e}")
        # band-row counts that are no multiple of the resident clusters
        # (1, 7, one more than the grid), the other block size of this N,
        # and an output view at an address that is 8- but not 16-byte
        # aligned
        plan = cluster_plan(n)
        G = resident_clusters(n, plan["cluster"], 0)
        other = (plan["cluster"] // 2 if plan["points"] == 8192
                 else plan["cluster"] * 2)
        kw = dict(pad=n // 4, length=n // 2)
        Fg = torch.complex(randn((G + 1, n), gen), randn((G + 1, n), gen))
        bk = banks["graded"]
        cases = [("1 band-row", Fg[:1], bk[3:4], None),
                 ("7 band-rows", Fg[:1], torch.cat([bk, bk[:1]]), None),
                 (f"{G + 1} band-rows on {G} clusters", Fg, bk[3:4], None)]
        if 1 <= other <= 8:
            cases.append((f"clusters of {other}", F, bk, other))
        for label, Fc, bc, cl in cases:
            ref = cwt_ifft_bank_ref(Fc, bc, **kw)
            if cl is None:
                got = cwt_ifft_bank(Fc, bc, **kw)
            else:
                got = cuda_cwt._launch(Fc, bc, None, torch.empty_like(ref),
                                       n // 4, n // 2, False, cluster=cl)
            torch.cuda.synchronize()
            e, pk = complex_err(got, ref)
            check(f"cwt_ifft_bank n={n} {label}", e / pk, FP32_TOL)
            worst = max(worst, e / pk)
        ref = cwt_ifft_bank_ref(F, bk, pad=1000, length=12344, det=True)
        buf = torch.empty(ref.numel() + 1, dtype=torch.complex64,
                          device="cuda")
        view = buf[1:].view(ref.shape)
        if view.data_ptr() % 16 != 8:
            raise AssertionError("the output view is not off alignment")
        cuda_cwt._launch(F, bk, None, view, 1000, 12344, True)
        torch.cuda.synchronize()
        e, pk = complex_err(view, ref)
        check(f"cwt_ifft_bank n={n} output at an 8-byte address", e / pk,
              FP32_TOL)
        worst = max(worst, e / pk)
        check(f"cwt_ifft_bank n={n} (3 banks x 3 slices x det x row_h; "
              f"clusters of {plan['cluster']}, {G} resident)", worst,
              FP32_TOL)

    # --- unwrap_diff: bit-equal on every kind of phase and odd shapes
    # (rows no multiple of 4 long take the scalar loads and stores) -------
    for rows, T in ((7, 1000), (1, 1), (3, 513), (1344, 32768), (2, 3),
                    (5, 17), (3, 8191), (4, 8193), (2, 16385)):
        for label, ph in wrapped_phases(rows, T, gen).items():
            got = unwrap_diff(ph)
            torch.cuda.synchronize()
            ref = unwrap_diff_ref(ph)
            if not torch.equal(got, ref):
                raise AssertionError(
                    f"unwrap_diff {rows}x{T} {label}: "
                    f"{int((got != ref).sum())} cells differ")
        print(f"  unwrap_diff {rows}x{T}: wrapping, drifting, steady and "
              "noise phases equal to the plain version, bit for bit")

    # --- synsq_bins: the three scale kinds, with and without a threshold,
    # on cells whose phases wrap, drift, sit at the knife edge or are noise
    # and whose powers straddle the threshold ------------------------------
    layouts = {
        # the wavelet path's octave bands from C1, 12 a octave
        "log": 32.703 * 2 ** (torch.arange(WAV_NUM, device="cuda") / 12),
        "linear": torch.linspace(100.0, 8000.0, WAV_NUM, device="cuda"),
        "nearest": torch.sort(torch.rand(WAV_NUM, generator=gen,
                                         device="cuda") * 15000 + 20)[0]}
    worst = worst_bin = 0
    for B, T in ((2, 1), (2, 2), (1, 3), (3, 17), (2, 1000), (1, 8193),
                 (2, 32768)):
        cells = synsq_cells(B, T, gen)
        for kind, fre_k in layouts.items():
            for thresh in (None, 0.001):
                got = synsq_bins(cells, fre_k, kind, WAV_NUM, SR, thresh)
                torch.cuda.synchronize()
                ref = synsq_bins_ref(cells, fre_k, kind, WAV_NUM, SR, thresh)
                bad = got != ref
                worst = max(worst, int(bad.sum()))
                if bool(bad.any()):
                    worst_bin = max(worst_bin,
                                    int((got - ref)[bad].abs().max()))
                # the kernel is built to match its plain version bit for
                # bit, so one differing cell fails (a boundary fault moves
                # a few cells and keeps the scattered mass)
                if not torch.equal(got, ref):
                    raise AssertionError(
                        f"synsq_bins {B}x{WAV_NUM}x{T} {kind} thresh="
                        f"{thresh}: {int(bad.sum())} cells differ")
        print(f"  synsq_bins {B}x{WAV_NUM}x{T}: log, linear and nearest, "
              "with and without a threshold, equal to the plain version")
    print(f"  synsq_bins: at most {worst} cells differ from the plain version "
          "in any case above")

    # --- columnar_scatter: bit-equal; R = F, R != F, out_size 512, all
    # dropped, T = 1 and T = 32768 -----------------------------------------
    for B, R, F_, T, lo in ((3, 84, 84, 1000, -1), (2, 16, 40, 129, -3),
                            (2, 40, 16, 32768, 0), (1, 100, 512, 300, -1),
                            (2, 84, 84, 1, -1), (2, 84, 84, 32768, -1),
                            (2, 8, 8, 128, None)):
        v = torch.complex(randn((B, R, T), gen), randn((B, R, T), gen))
        if lo is None:     # every cell dropped
            fi = torch.full((B, R, T), F_, dtype=torch.int32, device="cuda")
        else:              # duplicates, the drop bin and negative indices
            fi = torch.randint(lo, F_ + 2, (B, R, T), generator=gen,
                               device="cuda", dtype=torch.int32)
        got = columnar_scatter(v, fi, F_)
        torch.cuda.synchronize()
        ref = columnar_scatter_ref(v, fi, F_)
        if not torch.equal(torch.view_as_real(got), torch.view_as_real(ref)):
            raise AssertionError(f"columnar_scatter B={B} R={R} F={F_} T={T}: "
                                 "differs from the plain version")
        if lo is None and bool((got != 0).any()):
            raise AssertionError("columnar_scatter: dropped cells leaked")
        print(f"  columnar_scatter B={B} R={R} out_size={F_} T={T}: equal to "
              "the plain version, bit for bit")
    errs.update(cwt_ifft_bank=0.0, unwrap_diff=0.0, columnar_scatter=0.0,
                synsq_bins=worst_bin)


def gate(label, dev_out, plan_cpu, x_cpu):
    ref = plan_cpu.spectrogram(x_cpu)
    check(f"gate {label} vs CPU .spectrogram()",
          rel_err(dev_out.cpu(), ref), GATE_TOL)
    return ref


COUNTERS = {"fft_pow2": (fft_fwd, "launches"),
            "fft_pow2 register route": (fft_fwd, "register_launches"),
            "fft_pow2 real-row route": (fft_fwd, "real_launches"),
            "fft_pow2 row route": (fft_fwd, "row_launches"),
            "fft_pow2 cluster route": (fft_fwd, "cluster_launches"),
            "fft_inv": (fft_inv, "launches"),
            "fft_inv register route": (fft_inv, "register_launches"),
            "fft_inv real-row route": (fft_inv, "real_launches"),
            "fft_inv row route": (fft_inv, "row_launches"),
            "fft_inv cluster route": (fft_inv, "cluster_launches"),
            "fft_pow2 live span": (fft_fwd, "live_launches"),
            "fft_inv half spectrum": (fft_inv, "half_launches"),
            "fft_autocorr": (fft_autocorr, "launches"),
            "fft_autocorr cluster": (fft_autocorr, "cluster_launches"),
            "fft_autocorr_yin": (fft_autocorr_yin, "launches"),
            "fft_autocorr_frames": (fft_autocorr_frames, "launches"),
            "median_filter": (median_filter_last_axis, "launches"),
            "median_filter network": (median_filter_last_axis,
                                      "network_launches")}


def zero_counts():
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)


def read_counts():
    return {k: getattr(fn, attr) for k, (fn, attr) in COUNTERS.items()}


def require_launched(path, launches):
    print(f"  launches on the {path} path: {launches}")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"{k} was not launched on the {path} path")


def phase3_mel_path(gen):
    phase("phase 3a: mel+MFCC path at full size")
    plan = MelSpectrogram(num=NUM, samplate=SR, radix2_exp=R2E,
                          slide_length=SLIDE, device="cuda")
    plan_cpu = MelSpectrogram(num=NUM, samplate=SR, radix2_exp=R2E,
                              slide_length=SLIDE, device="cpu")
    clip_len = (T_HEAD - 1) * SLIDE + (1 << R2E)  # 513536 samples
    x = randn((N_CLIPS, clip_len), gen, 0.2)
    xs = randn((N_CLIPS, 4096), gen, 0.2)
    torch.cuda.synchronize()

    zero_counts()
    fused_mel_mfcc.launches = 0
    mel, cc = plan.spectrogram_mfcc_fused(x, cc_num=CC)
    mel_s, cc_s = plan.spectrogram_mfcc_fused(xs, cc_num=CC)
    spec = plan.spectrogram(x[:8])
    torch.cuda.synchronize()
    launches = {"fused_mel_mfcc": fused_mel_mfcc.launches,
                "fft_pow2": fft_fwd.launches,
                "fft_pow2 register route (.spectrogram())":
                    fft_fwd.register_launches}
    require_launched("mel+MFCC", launches)

    for name, t, shape in (("mel", mel, (N_CLIPS, NUM, T_HEAD)),
                           ("cc", cc, (N_CLIPS, CC, T_HEAD)),
                           ("mel T=5", mel_s, (N_CLIPS, NUM, 5)),
                           ("cc T=5", cc_s, (N_CLIPS, CC, 5))):
        if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name}: shape {tuple(t.shape)} or "
                                 "non-finite values")
    # the whole batch against the plain version on the card, in chunks
    fplan = plan._fused_cache[CC]
    err_mel = err_cc = 0.0
    for lo in range(0, N_CLIPS, 250):
        mel_r, cc_r = fused_mel_mfcc_ref(fplan, x[lo:lo + 250])
        err_mel = max(err_mel, rel_err(mel[lo:lo + 250], mel_r))
        err_cc = max(err_cc, rel_err(cc[lo:lo + 250], cc_r))
        del mel_r, cc_r
    check(f"fused mel (T=1000, all {N_CLIPS} clips) vs plain", err_mel,
          FP32_TOL)
    check(f"fused cc (T=1000, all {N_CLIPS} clips) vs plain", err_cc,
          FP32_TOL)
    mel_r, cc_r = fused_mel_mfcc_ref(fplan, xs)
    check(f"fused mel (T=5, all {N_CLIPS} clips) vs plain",
          rel_err(mel_s, mel_r), FP32_TOL)
    check(f"fused cc (T=5, all {N_CLIPS} clips) vs plain",
          rel_err(cc_s, cc_r), FP32_TOL)

    # the exact path on the CPU, at the first and the last clips
    for sl, at in ((slice(0, 2), "first"), (slice(-2, None), "last")):
        ref = gate(f"fused mel (T=1000, {at} 2 clips)", mel[sl], plan_cpu,
                   x[sl].cpu())
        check(f"fused cc (T=1000, {at} 2 clips) vs CPU xxcc",
              rel_err(cc[sl].cpu(), plan_cpu.xxcc(ref, CC)), GATE_TOL)
        ref_s = gate(f"fused mel (T=5, {at} 2 clips)", mel_s[sl],
                     plan_cpu, xs[sl].cpu())
        check(f"fused cc (T=5, {at} 2 clips) vs CPU xxcc",
              rel_err(cc_s[sl].cpu(), plan_cpu.xxcc(ref_s, CC)), GATE_TOL)
    gate(".spectrogram() on the card (first 2 of 8 clips)", spec[:2],
         plan_cpu, x[:2].cpu())
    gate(".spectrogram() on the card (last 2 of 8 clips)", spec[-2:],
         plan_cpu, x[6:8].cpu())
    return plan, x, xs, launches


def mir_signal(n_clips, n, gen):
    """(n_clips, n) test audio: per clip a tone with vibrato and one
    overtone (so that YIN finds real troughs), a click train (so that HPSS
    has a percussive part) and low noise."""
    def u(lo, hi):
        return lo + (hi - lo) * torch.rand((n_clips, 1), generator=gen,
                                           device="cuda")
    t = torch.arange(n, device="cuda", dtype=torch.float32) / SR
    f0, rate, depth = u(110.0, 880.0), u(4.0, 7.0), u(0.002, 0.01)
    ph = 2 * math.pi * (f0 * t + depth * f0 / (2 * math.pi * rate)
                        * torch.sin(2 * math.pi * rate * t))
    x = 0.4 * torch.sin(ph) + 0.15 * torch.sin(2 * ph)
    del ph
    period = (u(0.3, 0.7) * SR).long()
    idx = torch.arange(n, device="cuda")
    clicks = ((idx % period) < 64).to(torch.float32)
    x += clicks * randn((n_clips, n), gen, 0.6)
    x += randn((n_clips, n), gen, 0.01)
    return x


def whole_batch(label, fn, ref_fn, tensors, chunk, tol=None):
    """Hold ``fn(*tensors)`` against ``ref_fn`` over the whole batch, the
    plain version run in chunks of ``chunk`` along axis 0.  ``tol=None``
    demands equality value for value."""
    got = fn(*tensors)
    got = got if isinstance(got, tuple) else (got,)
    err = peak = 0.0
    for lo in range(0, tensors[0].shape[0], chunk):
        ref = ref_fn(*(t[lo:lo + chunk] for t in tensors))
        ref = ref if isinstance(ref, tuple) else (ref,)
        part = tuple(g[lo:lo + chunk] for g in got)
        if tol is None:
            if not all(torch.equal(g, r) for g, r in zip(part, ref)):
                raise AssertionError(f"{label}: differs from the plain "
                                     f"version in clips {lo}..{lo + chunk}")
        else:
            e, pk = pair_err(part, ref)
            err, peak = max(err, e), max(peak, pk)
        del ref
    if tol is None:
        print(f"  {label}: equal to the plain version, value for value")
        return 0.0
    check(label, err / peak, tol)
    return err


def hpss_yin_gates(label, x, h, p, yin):
    """HPSS's and YIN's gates against the port on the CPU, on the clips
    ``x`` (on the card) whose HPSS outputs on the card are ``h``, ``p``:
    h and p at 1e-4 of the input's peak, YIN's CMND matrix at atol = rtol
    = 2e-4 and its frequencies within 1e-2 Hz on >= 99% of the frames."""
    x_cpu = x.cpu()
    cpu = {"device": "cpu"}
    h_c, p_c = HPSS(radix2_exp=R2E, window_type=WindowType.HAMM,
                    slide_length=SLIDE, h_order=H_ORDER, p_order=P_ORDER,
                    **cpu).hpss(x_cpu)
    peak = float(x_cpu.abs().max())
    check(f"gate HPSS h ({label}) vs CPU",
          float((h.cpu() - h_c).abs().max()) / peak, GATE_TOL)
    check(f"gate HPSS p ({label}) vs CPU",
          float((p.cpu() - p_c).abs().max()) / peak, GATE_TOL)
    yin_c = PitchYIN(samplate=SR, radix2_exp=YIN_R2E, slide_length=YIN_SLIDE,
                     **cpu)
    fre_c, _ = yin_c.pitch(x_cpu)
    fre_e, _ = yin.pitch(x)
    got, ref = yin._yin_mat.cpu(), yin_c._yin_mat
    excess = float(((got - ref).abs() - YIN_TOL * ref.abs()).max())
    print(f"  gate YIN CMND matrix ({label}) vs CPU: max "
          f"|diff| - rtol*|ref| = {excess:.3e} (atol {YIN_TOL:.0e})")
    if not excess <= YIN_TOL:
        raise AssertionError("YIN CMND matrix outside atol = rtol = 2e-4")
    near = (fre_e.cpu() - fre_c).abs() <= FRE_TOL_HZ
    print(f"  gate YIN fre within {FRE_TOL_HZ} Hz of the CPU on "
          f"{int(near.sum())} of {near.numel()} frames "
          f"({near.numel() - int(near.sum())} knife-edge frames)")
    if float(near.float().mean()) < FRE_SHARE:
        raise AssertionError("YIN fre agrees on fewer than 99% of the frames")


def phase3_mir_path(gen, errs):
    phase(f"phase 3b: MIR path at full size ({MIR_CLIPS} clips of "
          f"{MIR_SECONDS} s)")
    n = MIR_SECONDS * SR
    hp = HPSS(radix2_exp=R2E, window_type=WindowType.HAMM, slide_length=SLIDE,
              h_order=H_ORDER, p_order=P_ORDER)
    yin = PitchYIN(samplate=SR, radix2_exp=YIN_R2E, slide_length=YIN_SLIDE)
    st = STFT(radix2_exp=R2E, window_type=WindowType.HANN, slide_length=SLIDE)
    x = mir_signal(MIR_CLIPS, n, gen)
    torch.cuda.synchronize()

    # each user's call with the counts set to 0 just before it and read
    # just after; the route counts show that the register FFT (n = 2048)
    # and the median networks (orders 21, 31) ran
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    h, p = hp.hpss(x)
    torch.cuda.synchronize()
    hpss_counts = read_counts()
    require_launched("HPSS.hpss", {k: hpss_counts[k] for k in (
        "fft_pow2", "fft_pow2 register route", "fft_inv",
        "fft_inv register route", "median_filter", "median_filter network")})
    zero_counts()
    held, mir_peak = (torch.cuda.memory_allocated(),
                      torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()
    fre, val = yin.pitch(x)
    torch.cuda.synchronize()
    yin_counts = read_counts()
    print(f"  PitchYIN.pitch: peak device memory above its input "
          f"{(torch.cuda.max_memory_allocated() - held) / 1e9:.2f} GB")
    require_launched("PitchYIN.pitch", {"fft_autocorr_yin":
                                        yin_counts["fft_autocorr_yin"]})
    zero_counts()
    D = st.stft(x)
    xrt = st.istft(D)
    torch.cuda.synchronize()
    stft_counts = read_counts()
    require_launched("STFT.stft -> .istft", {k: stft_counts[k] for k in (
        "fft_pow2", "fft_pow2 register route", "fft_inv",
        "fft_inv register route")})
    launches = {k: hpss_counts[k] + yin_counts[k] + stft_counts[k]
                for k in ("fft_pow2", "fft_inv", "fft_autocorr",
                          "fft_autocorr_yin", "median_filter")}
    mir_peak = max(mir_peak, torch.cuda.max_memory_allocated())
    print(f"  peak device memory on the MIR path: {mir_peak / 1e9:.2f} GB")

    T = hp.cal_time_length(n)
    Ty = yin.cal_time_length(n)
    for name, t, shape in (("h", h, (MIR_CLIPS, hp.cal_data_length(n))),
                           ("p", p, (MIR_CLIPS, hp.cal_data_length(n))),
                           ("fre", fre, (MIR_CLIPS, Ty)),
                           ("val", val, (MIR_CLIPS, Ty)),
                           ("stft", D, (MIR_CLIPS, (1 << R2E) // 2 + 1, T)),
                           ("istft", xrt, (MIR_CLIPS, st.cal_data_length(T)))):
        if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name}: shape {tuple(t.shape)} or "
                                 "non-finite values")
    voiced = float((fre > 0).float().mean())
    print(f"  YIN: {voiced:.1%} of {fre.numel()} frames voiced")
    if voiced < 0.5:
        raise AssertionError("the test signal left YIN mostly unvoiced")
    span = slice(1 << R2E, xrt.shape[-1] - (1 << R2E))
    check("STFT -> ISTFT round trip vs the input (interior, all clips)",
          rel_err(xrt[:, span], x[:, span]), GATE_TOL)
    check("h + p vs the input (interior, all clips)",
          rel_err((h + p)[:, span], x[:, span]), GATE_TOL)
    del D, xrt

    # every kernel's whole-batch output against its plain version, at the
    # inputs the entry points gave it (rebuilt here as hpss and pitch do)
    m = (1 << R2E) // 2 + 1
    rows = (x.unfold(-1, 1 << R2E, SLIDE) * hp._window_t).contiguous()
    errs["fft_pow2"] = max(errs["fft_pow2"], whole_batch(
        f"fft_pow2 forward, all {rows.numel() >> R2E} HPSS rows vs plain",
        fft_fwd, fft_fwd_ref, (rows,), 8, FFT_TOL))
    zr, zi = fft_fwd(rows)
    del rows
    mag = torch.sqrt(zr * zr + zi * zi)[..., :m].contiguous()
    errs["median_filter"] = whole_batch(
                f"median order {H_ORDER} over time, {mag.numel()} cells",
                lambda t: median_filter_last_axis(t, H_ORDER, dim=-2),
                lambda t: median_filter_last_axis_ref(t, H_ORDER, dim=-2),
                (mag,), 4)
    errs["median_filter"] += whole_batch(
                f"median order {P_ORDER} over frequency, {mag.numel()} cells",
                lambda t: median_filter_last_axis(t, P_ORDER),
                lambda t: median_filter_last_axis_ref(t, P_ORDER),
                (mag,), 4)
    hm = median_filter_last_axis(mag, H_ORDER, dim=-2)
    pm = median_filter_last_axis(mag, P_ORDER)
    h2, p2 = hm * hm, pm * pm
    del hm, pm
    denom = torch.clamp(h2 + p2, min=1e-16)
    mirror = lambda M: torch.cat([M, M[..., 1:m - 1].flip(-1)], dim=-1)
    Mh, Mp = mirror(h2 / denom), mirror(p2 / denom)
    del h2, p2, denom
    pr, pi = Mh * zr - Mp * zi, Mh * zi + Mp * zr
    del Mh, Mp, zr, zi
    errs["fft_inv"] = max(errs["fft_inv"], whole_batch(
        f"fft_inv, all {pr.numel() >> R2E} HPSS rows vs plain",
        fft_inv, fft_inv_ref, (pr, pi), 8, FFT_TOL))
    auto = yin.auto_length
    fr = x.unfold(-1, 1 << YIN_R2E, YIN_SLIDE).contiguous()
    rev = torch.nn.functional.pad(fr[..., :auto + 1].flip(-1),
                                  (0, (1 << YIN_R2E) - auto - 1))
    errs["fft_autocorr"] = max(errs["fft_autocorr"], whole_batch(
        f"fft_autocorr, all {fr.numel() >> YIN_R2E} YIN rows vs plain",
        fft_autocorr, fft_autocorr_ref, (fr, rev), 8, FFT_TOL))
    errs["fft_autocorr_yin"] = max(errs["fft_autocorr_yin"], whole_batch(
        f"fft_autocorr_yin, all {fr.numel() >> YIN_R2E} frames of the "
        f"{MIR_CLIPS} clips vs plain",
        lambda t: fft_autocorr_yin(t, 1 << YIN_R2E, YIN_SLIDE, auto),
        lambda t: fft_autocorr_yin_ref(t, 1 << YIN_R2E, YIN_SLIDE, auto),
        (x,), 8, FFT_TOL))

    # the first and the last clip against the port on the CPU
    ends = [0, MIR_CLIPS - 1]
    hpss_yin_gates("first and last clip", x[ends], h[ends], p[ends], yin)
    st_c = STFT(radix2_exp=R2E, window_type=WindowType.HANN,
                slide_length=SLIDE, device="cpu")
    check("gate STFT -> ISTFT (first and last clip) vs CPU",
          rel_err(st.istft(st.stft(x[ends])).cpu(),
                  st_c.istft(st_c.stft(x[ends].cpu()))), GATE_TOL)
    return dict(hp=hp, yin=yin, st=st, x=x, mag=mag, pr=pr, pi=pi, fr=fr,
                rev=rev, launches=launches)


def flips_and_mass(label, got, ref, flip_tol=FLIP_TOL):
    """The scatter transforms' gate: the share of cells of |got| that are
    off |ref| by more than ``flip_tol`` of the peak (bin flips of
    knife-edge cells; 1e-5 for synchrosqueezing, the benchmark's 1e-3 for
    reassignment) must stay <= 5e-3 and the summed magnitude within
    1e-4."""
    got, ref = got.abs().double(), ref.abs().double()
    peak = float(ref.max())
    flips = float(((got - ref).abs() > flip_tol * peak).double().mean())
    mass = abs(float(got.sum()) / max(float(ref.sum()), 1e-30) - 1)
    print(f"  {label}: flips {flips:.3e} (<= {FLIP_SHARE:.0e}), mass "
          f"{mass:.3e} (<= {MASS_TOL:.0e})", flush=True)
    if not (flips <= FLIP_SHARE and mass <= MASS_TOL):
        raise AssertionError(f"{label}: flips {flips:.3e}, mass {mass:.3e}")


def reassign_edges(got, ref, plan, x_dev, x_cpu):
    """What config 3's reassigned-BFT gate sees (``reassign_edge_gate``):
    a reassigned cell goes to bin floor(p + 0.5) of its corrected
    frequency p (and to its own bin where its power is below thresh^2),
    so a float32 p a rounding from a half-integer (or a power a rounding
    from the threshold) may land in either bin on two devices.  p and the
    power come from the plan's own code three times: on the card, on the
    CPU in float32, and on the CPU in float64 (float64 input and windows).
    A source cell moved between the card and the CPU lies on an edge when
    its float64 p is within delta of the crossed half-integer (or its
    float64 power within delta_p of thresh^2): delta = 4 x the frame's
    largest float32 deviation |p32 - p64| |S| over |S| of the cell (the
    deviation scales as 1 / |S|), plus 4 ulp of p; delta_p = 4 x the
    frame's largest |power32 - power64|.  Returns the counts, the flip
    share (band cells off the CPU's by more than 1e-3 of the peak), the
    mass over all band cells and over those no moved source cell on an
    edge touches, and each flipped cell with its source cells."""
    from audioflux_torch.transforms.reassign import _frequency_position
    re = plan._re
    kw = dict(fft_length=re.fft_length, slide_length=re.slide_length,
              samplate=re.samplate, thresh=re.thresh, re_type=re.re_type,
              is_padding=re.is_padding)
    p_d, w_d = (t.cpu().double() for t in _frequency_position(
        x_dev, re._wins_t, **kw))
    wins = torch.from_numpy(re._wins)
    p_c, w_c = (t.double() for t in _frequency_position(x_cpu, wins, **kw))
    p64, w64 = _frequency_position(x_cpu.double(), wins.double(), **kw)
    th2 = float(np.float32(re.thresh) ** 2)
    lo = plan.low_index
    nb = got.shape[-2]
    own_bin = torch.arange(p_d.shape[-1], dtype=torch.float64)
    on_d, on_c = w_d >= th2, w_c >= th2
    bin_d = torch.where(on_d, torch.floor(p_d + 0.5), own_bin)
    bin_c = torch.where(on_c, torch.floor(p_c + 0.5), own_bin)
    moved = bin_d != bin_c                                  # (clips, T, m)
    mag = w64.sqrt()
    scale = ((p_c - p64).abs() * mag).amax(-1, keepdim=True)
    delta = 4 * scale / mag.clamp_min(1e-30) + 4 * 2.0 ** -24 * p64.abs()
    edge = torch.minimum(bin_d, bin_c) + 0.5
    dist = (p64 - edge).abs()
    dp = 4 * (w_c - w64).abs().amax(-1, keepdim=True)
    near_w = (on_d != on_c) & ((w64 - th2).abs() <= dp)
    on_edge = moved & ((dist <= delta) | near_w)
    # band cells (clip, band, frame) a moved source cell on an edge touches:
    # the bins it went to on either device
    touched = torch.zeros(got.shape, dtype=torch.bool)
    n_edge = 0
    for c, f, k in on_edge.nonzero().tolist():
        n_edge += 1
        for b in {int(bin_d[c, f, k]), int(bin_c[c, f, k])}:
            if lo <= b < lo + nb:
                touched[c, b - lo, f] = True
    g, r = got.abs().double(), ref.abs().double()
    flip = (g - r).abs() > RE_FLIP_TOL * float(r.max())
    keep = ~touched
    cells = []
    for c, b, f in flip.nonzero().tolist():
        src = [dict(bin=k, p64=float(p64[c, f, k]),
                    edge=float(edge[c, f, k]), dist=float(dist[c, f, k]),
                    delta=float(delta[c, f, k]),
                    card=float((p_d - p64)[c, f, k]),
                    cpu=float((p_c - p64)[c, f, k]),
                    on_edge=bool(on_edge[c, f, k]))
               for k in moved[c, f].nonzero().flatten().tolist()
               if lo + b in (int(bin_d[c, f, k]), int(bin_c[c, f, k]))]
        cells.append(dict(clip=c, band=b, frame=f, card=float(g[c, b, f]),
                          cpu=float(r[c, b, f]),
                          on_edge=bool(touched[c, b, f]), sources=src))
    return dict(
        moved=int(moved.sum()), cells_total=moved.numel(), on_edge=n_edge,
        flips=float(flip.double().mean()),
        mass_all=abs(float(g.sum()) / max(float(r.sum()), 1e-30) - 1),
        mass=abs(float(g[keep].sum()) / max(float(r[keep].sum()), 1e-30) - 1),
        kept=int(keep.sum()), flipped=cells)


def print_reassign_edges(label, e):
    print(f"  {label}: {e['moved']} source cells of {e['cells_total']} "
          f"moved between card and CPU, {e['on_edge']} of them on an edge; "
          f"flips {e['flips']:.3e} (<= {FLIP_SHARE:.0e}), mass "
          f"{e['mass_all']:.3e} over all cells, {e['mass']:.3e} over the "
          f"{e['kept']} cells no edge touches (<= {MASS_TOL:.0e})",
          flush=True)
    for cell in e["flipped"]:
        print(f"    flipped cell: clip {cell['clip']}, band {cell['band']}, "
              f"frame {cell['frame']}: |card| {cell['card']:.6g}, |CPU| "
              f"{cell['cpu']:.6g}{'' if cell['on_edge'] else ' (no edge)'}")
        for src in cell["sources"]:
            print(f"      source bin {src['bin']}: float64 position "
                  f"{src['p64']:.9f}, edge {src['edge']:.1f}, distance "
                  f"{src['dist']:.3e} (float32 envelope {src['delta']:.3e}); "
                  f"card - float64 {src['card']:.3e}, CPU float32 - float64 "
                  f"{src['cpu']:.3e}")


def reassign_edge_gate(label, got, ref, plan, x_dev, x_cpu):
    """Config 3's reassigned-BFT gate by what it can see
    (``reassign_edges``): every flipped band cell must take a moved source
    cell on an edge, the share of flips stays <= 5e-3, and the mass of the
    band cells no such source cell touches within 1e-4."""
    e = reassign_edges(got, ref, plan, x_dev, x_cpu)
    print_reassign_edges(label, e)
    away = [(c["clip"], c["band"], c["frame"]) for c in e["flipped"]
            if not c["on_edge"]]
    if not (e["flips"] <= FLIP_SHARE and e["mass"] <= MASS_TOL
            and not away):
        raise AssertionError(f"{label}: flips {e['flips']:.3e}, mass "
                             f"{e['mass']:.3e}, flipped cells away from an "
                             f"edge {away}")


def scatter_inputs(sq, W, fre_t, fn=synsq_bins):
    """The index tensor that ``Synsq.synsq`` hands the scatter kernel
    (order 1): the bin map, dropped cells sent to bin ``num``."""
    return fn(W, fre_t, "log", sq.num, float(sq.samplate), sq.thresh)


def phase3_wavelet_path(gen, errs):
    n = 1 << WAV_R2E
    phase(f"phase 3c: wavelet path at full width ({WAV_SMALL} and "
          f"{WAV_CLIPS} clips of {n} samples, {WAV_NUM} bands)")
    morlet = dict(wavelet_type=WaveletContinueType.MORLET, scale_type=OCTAVE)
    cwt = CWT(**WAV_KW, **morlet)
    sq = Synsq(**WAV_KW)
    ws = WSST(**WAV_KW, **morlet)
    pw = PWT(**WAV_KW)
    fre = cwt.get_fre_band_arr()
    x = randn((WAV_CLIPS, n), gen, 0.2)
    xs = x[:WAV_SMALL]
    torch.cuda.synchronize()

    kernels = {"cwt_ifft_bank": cwt_ifft_bank, "synsq_bins": synsq_bins,
               "columnar_scatter": columnar_scatter}
    for fn in (*kernels.values(), unwrap_diff):
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    Ws = cwt.cwt(xs)
    Ys = sq.synsq(Ws, OCTAVE, fre)
    W = cwt.cwt(x)
    torch.cuda.synchronize()
    held, wav_peak = (torch.cuda.memory_allocated(),
                      torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()
    Y = sq.synsq(W, OCTAVE, fre)
    torch.cuda.synchronize()
    print(f"  Synsq.synsq ({WAV_CLIPS} clips): peak device memory above its "
          f"input {(torch.cuda.max_memory_allocated() - held) / 1e9:.2f} GB "
          f"(the output alone {Y.numel() * 8 / 1e9:.2f} GB)")
    A, Wc = ws.wsst(xs)
    P = pw.pwt(xs)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in kernels.items()}
    require_launched("wavelet", launches)
    launches["unwrap_diff"] = unwrap_diff.launches
    print(f"  the bare unwrap_diff entry on the wavelet path: "
          f"{unwrap_diff.launches} launches (Synsq takes synsq_bins)")
    wav_peak = max(wav_peak, torch.cuda.max_memory_allocated())
    print(f"  peak device memory on the wavelet path: {wav_peak / 1e9:.2f} GB")
    for name, t, clips in (("cwt", Ws, WAV_SMALL), ("synsq", Ys, WAV_SMALL),
                           ("cwt", W, WAV_CLIPS), ("synsq", Y, WAV_CLIPS),
                           ("wsst", A, WAV_SMALL), ("wsst cwt", Wc, WAV_SMALL),
                           ("pwt", P, WAV_SMALL)):
        if (tuple(t.shape) != (clips, WAV_NUM, n) or t.dtype != torch.complex64
                or not bool(torch.isfinite(torch.view_as_real(t)).all())):
            raise AssertionError(f"{name} x{clips}: shape {tuple(t.shape)}, "
                                 f"{t.dtype} or non-finite values")
    if not bool((Y.abs() > 0).any()):
        raise AssertionError("synsq scattered nothing")
    # one batch size, one result; across batch sizes the forward FFT (the
    # library's, which may plan 16 and 128 rows differently) moves last bits
    if not torch.equal(torch.view_as_real(Wc), torch.view_as_real(Ws)):
        raise AssertionError("WSST's cwt differs from CWT.cwt")
    e, pk = complex_err(W[:WAV_SMALL], Ws)
    check(f"cwt of the first {WAV_SMALL} clips, batch {WAV_CLIPS} vs batch "
          f"{WAV_SMALL}", e / pk, FP32_TOL)

    # every kernel's whole-batch output against its plain version, at the
    # inputs the entry points gave it (rebuilt here as they do)
    p = cwt.pad_length
    F = torch.fft.fft(_symmetric_pad(x, p), dim=-1)
    err = peak = 0.0
    for lo in range(0, WAV_CLIPS, 8):
        ref = cwt_ifft_bank_ref(F[lo:lo + 8], cwt._bank_t, pad=p, length=n)
        e, pk = complex_err(W[lo:lo + 8], ref)
        err, peak = max(err, e), max(peak, pk)
        del ref
    check(f"cwt_ifft_bank, all {WAV_CLIPS * WAV_NUM} band-rows of N="
          f"{n + 2 * p} vs plain", err / peak, FP32_TOL)
    errs["cwt_ifft_bank"] = err
    ref = cwt_ifft_bank_ref(F[:4], ws._cwt._det_bank_t, pad=p, length=n,
                            det=True)
    e, pk = complex_err(ws._cwt.cwt_det(xs[:4]), ref)
    check("cwt_ifft_bank det (the derivative bank, 4 clips) vs plain", e / pk,
          FP32_TOL)
    ref = cwt_ifft_bank_ref(F[:4], pw._bank_t, pad=p, length=n)
    e, pk = complex_err(P[:4], ref)
    check("cwt_ifft_bank PWT bank (4 clips) vs plain", e / pk, FP32_TOL)
    del F, ref

    ph = torch.atan2(W.real, W.imag).reshape(-1, n)
    whole_batch(f"unwrap_diff, all {ph.shape[0]} rows of {n}", unwrap_diff,
                unwrap_diff_ref, (ph,), 8 * WAV_NUM)
    del ph
    fre_t = torch.from_numpy(fre).cuda()
    fi = scatter_inputs(sq, W, fre_t)
    # synsq_bins against its plain version over every cell: the count of
    # cells that differ (atan2f and log2f are the card's own in both)
    differ = worst_bin = 0
    for lo in range(0, WAV_CLIPS, 8):
        ref = scatter_inputs(sq, W[lo:lo + 8], fre_t, synsq_bins_ref)
        bad = fi[lo:lo + 8] != ref
        differ += int(bad.sum())
        if bool(bad.any()):
            worst_bin = max(worst_bin, int((fi[lo:lo + 8] - ref)[bad].abs()
                                           .max()))
        del ref, bad
    print(f"  synsq_bins, all {WAV_CLIPS} x {WAV_NUM} x {n} cells vs plain: "
          f"{differ} cells differ (largest bin difference {worst_bin})")
    if differ:
        raise AssertionError(f"synsq_bins: {differ} cells differ")
    errs["synsq_bins"] = max(errs["synsq_bins"], worst_bin)
    got = columnar_scatter(W, fi, WAV_NUM)
    for lo in range(0, WAV_CLIPS, 8):
        ref = columnar_scatter_ref(W[lo:lo + 8], fi[lo:lo + 8], WAV_NUM)
        if not torch.equal(torch.view_as_real(got[lo:lo + 8]),
                           torch.view_as_real(ref)):
            raise AssertionError("columnar_scatter differs from the plain "
                                 f"version in clips {lo}..{lo + 8}")
    print(f"  columnar_scatter, all {WAV_CLIPS} x {WAV_NUM} x {n} cells: "
          "equal to the plain version, bit for bit "
          f"({float((fi < WAV_NUM).float().mean()):.1%} of the cells kept)")
    if not torch.equal(torch.view_as_real(got), torch.view_as_real(Y)):
        raise AssertionError("Synsq.synsq did not return the scatter "
                             "kernel's output")
    del got

    # the kernel path against the pinned prefix-sum unwrap on the card
    flips_and_mass(f"synsq kernel path vs force_xla_unwrap ({WAV_SMALL} "
                   "clips)", Ys,
                   sq.synsq(Ws, OCTAVE, fre, force_xla_unwrap=True))

    # the first and the last clip against the port on the CPU
    ends = [0, WAV_CLIPS - 1]
    x_cpu = x[ends].cpu()
    cpu = {"device": "cpu"}
    cwt_c = CWT(**WAV_KW, **morlet, **cpu)
    W_c = cwt_c.cwt(x_cpu)
    check("gate |cwt| (first and last clip) vs CPU",
          rel_err(W[ends].abs().cpu(), W_c.abs()), GATE_TOL)
    Y_c = Synsq(**WAV_KW, **cpu).synsq(W_c[:1], OCTAVE, fre)
    flips_and_mass("gate |synsq(cwt(x))| (first clip) vs CPU", Y[:1].cpu(),
                   Y_c)
    A_c, _ = WSST(**WAV_KW, **morlet, **cpu).wsst(x_cpu[:1])
    flips_and_mass("gate |wsst| (first clip) vs CPU", A[:1].cpu(), A_c)
    check("gate |pwt| (first clip) vs CPU",
          rel_err(P[:1].abs().cpu(), PWT(**WAV_KW, **cpu).pwt(
              x_cpu[:1]).abs()), GATE_TOL)
    return dict(cwt=cwt, sq=sq, ws=ws, pw=pw, x=x, W=W, fi=fi, fre=fre,
                fre_t=fre_t, launches=launches)


def phase4_timing(plan, x, xs, launches, errs):
    phase("phase 4a: mel+MFCC timing (CUDA events, median)")
    rows = []

    # --- fused_mel_mfcc at the headline shape --------------------------
    fplan = plan._fused_cache[CC]
    B, n = x.shape
    T = (n - plan.fft_length) // SLIDE + 1
    k_ms = cuda_ms(lambda: fused_mel_mfcc(fplan, x), reps=10)
    chunks = torch.split(x, 250)
    p_ms = cuda_ms(lambda: [fused_mel_mfcc_ref(fplan, c) for c in chunks],
                   reps=3, warmup=1)
    frames_w = [(c.unfold(-1, plan.fft_length, SLIDE) * fplan.window)
                .contiguous() for c in chunks]

    def library():
        for f in frames_w:
            s = torch.fft.rfft(f, dim=-1)
            mel = torch.matmul(s.real.square() + s.imag.square(),
                               fplan.mel_fb.T)
            torch.matmul(torch.log10(torch.clamp(mel, min=1e-8)),
                         fplan.dct.T)
    l_ms = cuda_ms(library, reps=3, warmup=1)
    del frames_w
    nfft = plan.fft_length
    frames = B * T
    n_bytes = 4 * (B * n + B * (NUM + CC) * T)
    n_flops = frames * (2.5 * nfft * math.log2(nfft) + 2 * fplan.band_nnz
                        + NUM + 2 * CC * NUM)
    rows.append(kernel_row(
        "fused_mel_mfcc", "fused_mel_mfcc",
        "audioflux_tpu/ops/pallas_spectrogram.py:1250",
        launches["fused_mel_mfcc"], errs["fused_mel_mfcc"], k_ms, p_ms, l_ms,
        n_bytes, n_flops, f"{B}x{n}"))

    # the kernel cut after each stage: the differences split its time
    cut_ms = [cuda_ms(lambda s=s: _launch(fplan, x, T, stages=s), reps=10)
              for s in (1, 2, 3)] + [k_ms]
    for s, name in enumerate(("span load + window + first pass",
                              "second pass + power", "filterbank + log10",
                              "DCT")):
        prev = cut_ms[s - 1] if s else 0.0
        print(f"  split: {name}: {cut_ms[s] - prev:.3f} ms "
              f"(cut after it: {cut_ms[s]:.3f} ms)")

    # headline end to end: the user's call, audio-hours per second
    e2e_ms = cuda_ms(lambda: plan.spectrogram_mfcc_fused(x, cc_num=CC),
                     reps=10)
    audio_hours = B * n / SR / 3600.0
    print(f"  headline spectrogram_mfcc_fused {B}x T={T}: {e2e_ms:.3f} ms, "
          f"{audio_hours / (e2e_ms / 1e3):.1f} audio-hours/s; outside the "
          f"kernel (difference of medians): {e2e_ms - k_ms:.3f} ms")

    # short clips (1000 x 4096 samples, T=5): the fused kernel runs every
    # frame count; until the T<8 fork was removed this call took
    # FORK_SHORT_CLIP_MS through a batched FFT and two matmuls
    e2e_s = cuda_ms(lambda: plan.spectrogram_mfcc_fused(xs, cc_num=CC),
                    reps=20)
    hours_s = xs.shape[0] * xs.shape[1] / SR / 3600.0
    print(f"  short-clip spectrogram_mfcc_fused {xs.shape[0]}x{xs.shape[1]}: "
          f"{e2e_s:.4f} ms, {hours_s / (e2e_s / 1e3):.1f} audio-hours/s "
          f"(the removed T<8 fork: {FORK_SHORT_CLIP_MS} ms)")
    if not e2e_s <= FORK_SHORT_CLIP_MS:
        raise AssertionError("the short-clip call is slower than the fork "
                             "it replaced")
    return rows


def kernel_row(name, source, replaces, launches, err, k_ms, p_ms, l_ms,
               n_bytes, n_ops, what, bound=None, entry=None):
    """The kernels line's entry; ``bound`` (ms, "bytes" or "operations")
    replaces the fp32 reckoning where the operations are not flops;
    ``entry`` names the wrapper where a kernel has more than one;
    ``l_ms`` is None where no one PyTorch call computes the function."""
    b_ms, b_by = bound or bound_ms(n_bytes, n_ops)
    lib = "none" if l_ms is None else f"{l_ms:.3f} ms"
    print(f"  {entry or name} {what}: kernel {k_ms:.3f} ms, plain "
          f"{p_ms:.3f} ms, library {lib}, bound {b_ms:.3f} ms ({b_by}: "
          f"{n_bytes / 1e9:.3f} GB, {n_ops / 1e9:.2f} G operations)")
    row = {"name": name, "route": "cuda",
           "source": f"audioflux_torch/csrc/{source}.cu",
           "replaces": replaces, "launches": launches, "max_abs_err": err,
           "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": l_ms}
    if entry is not None:
        row["entry"] = entry
    return row


def with_entries(main, *others):
    """A kernel of several entries: the kernels line's entry is the one
    the main paths launch, and ``entries`` lists every entry's numbers.
    ``measures`` says so in the row: the top-level keys of these kernels
    timed the first entry (``others[0]``, the kernel's own contract)
    before the main paths took the fused one, so readings from before
    that are compared with the first entry under ``entries``."""
    first = others[0]["entry"]
    return dict(main, measures=(
        f"top-level keys: the {main['entry']} entry, which the main paths "
        f"launch; they timed the {first} entry before {main['entry']} "
        f"existed: compare older readings with {first} under entries"),
        entries=[dict(r) for r in (*others, main)])


def chunked(fn, tensors, chunk):
    """``fn`` over chunks of ``chunk`` along axis 0 (what fits the card)."""
    def run():
        for lo in range(0, tensors[0].shape[0], chunk):
            fn(*(t[lo:lo + chunk] for t in tensors))
    return run


def phase4_mir_timing(mir, mel_launches, errs):
    phase("phase 4b: MIR path timing (CUDA events, median)")
    rows = []
    hp, yin, st, x = mir["hp"], mir["yin"], mir["st"], mir["x"]
    launches = mir["launches"]
    nfft, ny = 1 << R2E, 1 << YIN_R2E

    # --- fft_pow2 forward at the HPSS shape (real input) ----------------
    frames = (x.unfold(-1, nfft, SLIDE) * hp._window_t).contiguous()
    nrows = frames.numel() // nfft
    k_ms = cuda_ms(lambda: fft_fwd(frames), reps=10)
    p_ms = cuda_ms(chunked(fft_fwd_ref, (frames,), 16), reps=3, warmup=1)
    l_ms = cuda_ms(chunked(lambda t: torch.fft.fft(t, dim=-1), (frames,),
                           16), reps=3, warmup=1)
    rows.append(kernel_row(
        "fft_pow2", "fft_pow2", "audioflux_tpu/ops/pallas_fft.py:346",
        launches["fft_pow2"] + mel_launches["fft_pow2"], errs["fft_pow2"],
        k_ms, p_ms, l_ms, 12 * frames.numel(),
        nrows * 5.0 * nfft * math.log2(nfft), f"forward {nrows}x{nfft} real"))
    # the register route cut after each stage (every cut stores as many
    # values as the whole kernel): the differences split its time
    cut_ms = [cuda_ms(lambda s=s: cuda_fft._fwd(frames, None, nfft, stages=s),
                      reps=10) for s in (1, 2)] + [k_ms]
    for s, name in enumerate(("load + first pass + store",
                              "second pass", "separation of the pairs")):
        prev = cut_ms[s - 1] if s else 0.0
        print(f"  split (fft_pow2 forward): {name}: {cut_ms[s] - prev:.3f} ms "
              f"(cut after it: {cut_ms[s]:.3f} ms)")
    del frames

    # --- fft_inv at the HPSS shape (complex in, complex out) ------------
    pr, pi = mir["pr"], mir["pi"]
    z = torch.complex(pr, pi)
    k_ms = cuda_ms(lambda: fft_inv(pr, pi), reps=10)
    p_ms = cuda_ms(chunked(fft_inv_ref, (pr, pi), 16), reps=3, warmup=1)
    l_ms = cuda_ms(chunked(lambda t: torch.fft.ifft(t, dim=-1), (z,), 16),
                   reps=3, warmup=1)
    rows.append(kernel_row(
        "fft_inv", "fft_pow2", "audioflux_tpu/ops/pallas_fft.py:360",
        launches["fft_inv"], errs["fft_inv"], k_ms, p_ms, l_ms, 16 * pr.numel(),
        nrows * 5.0 * nfft * math.log2(nfft), f"{nrows}x{nfft} complex"))
    r_ms = cuda_ms(lambda: fft_inv(pr, pi, out_imag=False), reps=10)
    print(f"  fft_inv out_imag=False (the ISTFT's call): {r_ms:.3f} ms")
    del z

    # --- fft_autocorr at the YIN shape ----------------------------------
    fr, rev = mir["fr"], mir["rev"]
    yrows = fr.numel() // ny
    z = torch.complex(fr, rev)

    def library(t):
        s = torch.fft.fft(t, dim=-1)
        return torch.fft.ifft(s * s, dim=-1)
    acf_ops = yrows * (10.0 * ny * math.log2(ny) + 6.0 * ny)
    k_ms = cuda_ms(lambda: fft_autocorr(fr, rev), reps=10)
    p_ms = cuda_ms(chunked(fft_autocorr_ref, (fr, rev), 16), reps=3,
                   warmup=1)
    l_ms = cuda_ms(chunked(library, (z,), 16), reps=3, warmup=1)
    general = kernel_row(
        "fft_autocorr", "fft_pow2", "audioflux_tpu/ops/pallas_fft.py:267",
        launches["fft_autocorr"], errs["fft_autocorr"], k_ms, p_ms, l_ms,
        12 * fr.numel(), acf_ops, f"{yrows}x{ny} rows (xr, xi)",
        entry="fft_autocorr")
    # YIN's entry: the clips in, the lags YIN keeps out; the library call
    # is fft -> square -> ifft on the frames packed beforehand, sliced
    auto = yin.auto_length
    kept = ny - auto
    yin_ms = cuda_ms(lambda: fft_autocorr_yin(x, ny, YIN_SLIDE, auto),
                     reps=10)
    p_ms = cuda_ms(chunked(lambda t: fft_autocorr_yin_ref(
        t, ny, YIN_SLIDE, auto), (x,), 8), reps=3, warmup=1)
    l_ms = cuda_ms(chunked(lambda t: library(t)[..., auto:].contiguous(),
                           (z,), 16), reps=3, warmup=1)
    rows.append(with_entries(kernel_row(
        "fft_autocorr", "fft_pow2", "audioflux_tpu/ops/pallas_fft.py:267",
        launches["fft_autocorr_yin"], errs["fft_autocorr_yin"], yin_ms,
        p_ms, l_ms, 4 * x.numel() + 4 * yrows * kept, acf_ops,
        f"{x.shape[0]} clips of {x.shape[1]} -> {yrows}x{kept} lags",
        entry="fft_autocorr_yin"), general))
    del z

    # --- the median kernel: HPSS's two calls, timed apart and together --
    # The bound counts min/max instructions, not flops: the min/max issue
    # rate is measured here by a probe kernel (a sorting network over 8
    # registers, 38 min/max a round, no memory traffic in its loop).
    mag = mir["mag"]
    cells = mag.numel()
    probe_threads, probe_iters = 132 * 2048 * 4, 256
    probe_ms = cuda_ms(lambda: cuda_median.minmax_probe(
        probe_threads, probe_iters, "cuda"), reps=5)
    rand_ms = cuda_ms(lambda: torch.rand((probe_threads, 8), device="cuda"),
                      reps=5)
    rate = probe_threads * probe_iters * 38 / ((probe_ms - rand_ms) * 1e-3)
    print(f"  min/max issue rate (probe, {probe_threads} threads x "
          f"{probe_iters} rounds x 38): {rate / 1e12:.2f} T/s")
    run = cuda_median.RUN
    minmax = {o: median_network.build(o, run).minmax_per_output
              for o in (H_ORDER, P_ORDER)}
    for o in (H_ORDER, P_ORDER):
        net = median_network.build(o, run)
        old_ce = median_network.batcher_single_count(o)
        print(f"  median network order {o}, runs of {run}: "
              f"{net.ce_per_output:.2f} compare-exchanges and "
              f"{net.minmax_per_output:.2f} min/max an output (one window "
              f"a thread: {old_ce} and {2 * old_ce})")

    def median_bound(cells_moved, ops):
        t_bytes = 8 * cells_moved / HBM_BYTES_PER_S * 1e3
        t_ops = ops / rate * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                     else "operations")
    timed = {}
    for what, order, dim in (("time axis, strided", H_ORDER, 1),
                             ("frequency axis, last", P_ORDER, 2)):
        k = cuda_ms(lambda: cuda_median._launch(mag, order, dim), reps=10)
        c = cuda_ms(lambda: cuda_median._launch(mag, order, dim, stages=1),
                    reps=10)
        ops = minmax[order] * cells
        b, by = median_bound(cells, ops)
        timed[order] = k
        print(f"  median order {order} ({what}), runs of {run}: {k:.3f} ms "
              f"(loads and stores alone {c:.3f} ms); bound {b:.3f} ms "
              f"({by}: {ops / 1e9:.2f} G min/max)")
    h_ms, f_ms = timed[H_ORDER], timed[P_ORDER]
    old_b, old_by = bound_ms(
        2 * 8 * cells, 2 * sum(median_network.batcher_single_count(o)
                               for o in (H_ORDER, P_ORDER)) * cells)
    print(f"  the bound as reckoned for one window a thread (its two min/max "
          f"a compare-exchange as two fp32 flops at 67 TFLOP/s): "
          f"{old_b:.3f} ms ({old_by})")
    g_ms = cuda_ms(lambda: median_filter_last_axis(mag, P_ORDER + 2),
                   reps=3, warmup=1)
    print(f"  median order {P_ORDER + 2} by rank counting (the path of the "
          f"orders without a network): {g_ms:.3f} ms")

    def both(fn):
        def run_both(t):
            fn(t, H_ORDER, -2)
            fn(t, P_ORDER, -1)
        return run_both

    def library_median(t, order, dim):
        t = t.movedim(dim, -1)
        half = order // 2
        torch.nn.functional.pad(t, (half, half)).unfold(-1, order, 1).median(
            dim=-1)
    p_ms = cuda_ms(chunked(both(median_filter_last_axis_ref), (mag,), 4),
                   reps=2, warmup=1)
    l_ms = cuda_ms(chunked(both(library_median), (mag,), 4), reps=2,
                   warmup=1)
    ops = (minmax[H_ORDER] + minmax[P_ORDER]) * cells
    rows.append(kernel_row(
        "median_filter", "median_filter",
        "audioflux_tpu/ops/pallas_median.py:108",
        launches["median_filter"], errs["median_filter"], h_ms + f_ms, p_ms,
        l_ms, 2 * 8 * cells, ops,
        f"orders {H_ORDER} + {P_ORDER} over {cells} cells (both HPSS calls; "
        f"operations are min/max at the probe's {rate / 1e12:.2f} T/s)",
        bound=median_bound(2 * cells, ops)))

    # --- the users' calls: audio-hours per second ------------------------
    call_ms = {}
    for clips in (MIR_CLIPS, MIR_SMALL):
        xb = x[:clips]
        hours = clips * x.shape[1] / SR / 3600.0
        for name, fn in (("HPSS.hpss", lambda: hp.hpss(xb)),
                         ("PitchYIN.pitch", lambda: yin.pitch(xb)),
                         ("STFT.stft -> .istft",
                          lambda: st.istft(st.stft(xb)))):
            ms = cuda_ms(fn, reps=5, warmup=1)
            call_ms[name, clips] = ms
            print(f"  {name} {clips}x{MIR_SECONDS} s: {ms:.3f} ms, "
                  f"{hours / (ms / 1e3):.1f} audio-hours/s")

    # --- PitchYIN.pitch's split at 64 clips ------------------------------
    frames = x.unfold(-1, ny, YIN_SLIDE)
    energy_ms = cuda_ms(lambda: torch.cumsum(frames * frames, dim=-1),
                        reps=5, warmup=1)
    whole = call_ms["PitchYIN.pitch", MIR_CLIPS]
    for name, ms in (("fft_autocorr_yin (framing, reversed prefix, "
                      "autocorrelation, the lags kept)", yin_ms),
                     ("energy: frames * frames, cumsum", energy_ms),
                     ("the rest: thresholds, the difference function, CMND, "
                      "trough search (the call less the two above)",
                      whole - yin_ms - energy_ms)):
        print(f"  split of PitchYIN.pitch at {MIR_CLIPS} clips: {name}: "
              f"{ms:.3f} ms")
    return rows


def phase4_wavelet_timing(wav, errs):
    phase("phase 4c: wavelet path timing (CUDA events, median)")
    rows = []
    cwt, sq, ws, pw = wav["cwt"], wav["sq"], wav["ws"], wav["pw"]
    x, W, fi, fre, fre_t = (wav[k] for k in ("x", "W", "fi", "fre", "fre_t"))
    launches = wav["launches"]
    n, p = 1 << WAV_R2E, cwt.pad_length
    N = n + 2 * p
    bank, row_h = cwt._bank_t, cwt._row_h_t
    F = torch.fft.fft(_symmetric_pad(x, p), dim=-1)
    ph = torch.atan2(W.real, W.imag).reshape(-1, n)

    def lib_ifft(Fc, pad=p, length=n):
        return torch.fft.ifft(bank * Fc[:, None, :], dim=-1)[
            ..., pad:pad + length]

    def lib_scatter(v, f):
        B = v.shape[0]
        buf = torch.zeros((B, WAV_NUM + 1, n, 2), device="cuda")
        buf.scatter_add_(1, f.long()[..., None].expand(B, WAV_NUM, n, 2),
                         torch.view_as_real(v))

    for clips in (WAV_CLIPS, WAV_SMALL):
        Fb, Wb, fib, phb = F[:clips], W[:clips], fi[:clips], ph[:clips * WAV_NUM]
        band_rows = clips * WAV_NUM
        cells = band_rows * n
        # --- cwt_ifft_bank ---------------------------------------------
        k_ms = cuda_ms(lambda: cwt_ifft_bank(Fb, bank, pad=p, length=n,
                                             row_h=row_h), reps=10)
        p_ms = cuda_ms(chunked(lambda t: cwt_ifft_bank_ref(
            t, bank, pad=p, length=n), (Fb,), 8), reps=3, warmup=1)
        l_ms = cuda_ms(chunked(lib_ifft, (Fb,), 8), reps=3, warmup=1)
        row = kernel_row(
            "cwt_ifft_bank", "cwt_ifft_bank",
            "audioflux_tpu/ops/pallas_cwt.py:183", launches["cwt_ifft_bank"],
            errs["cwt_ifft_bank"], k_ms, p_ms, l_ms,
            8 * clips * N + 4 * WAV_NUM * N + 8 * cells,
            band_rows * 5.0 * N * math.log2(N),
            f"{clips}x{WAV_NUM} band-rows, N={N}, {n} kept")
        if clips == WAV_CLIPS:
            rows.append(row)
            full = cuda_ms(lambda: cwt_ifft_bank(Fb, bank, pad=p, length=n),
                           reps=5)
            print(f"  cwt_ifft_bank without the support rows (row_h=None): "
                  f"{full:.3f} ms")
            G = resident_clusters(N, cluster_plan(N)["cluster"], 0)
            W_out = torch.empty_like(W)
            for cl, ncl in ((8, None), (4, None), (8, G // 2), (8, 2 * G)):
                got = ncl or resident_clusters(N, cl, 0)
                ms = cuda_ms(lambda: cuda_cwt._launch(
                    Fb, bank, row_h, W_out, p, n, False, cluster=cl,
                    n_clusters=ncl), reps=5)
                print(f"  cwt_ifft_bank with clusters of {cl} "
                      f"({N // cl // 16} threads a block), a grid of {got} "
                      f"clusters: {ms:.3f} ms")
            cut_ms = [cuda_ms(lambda s=s: cuda_cwt._launch(
                Fb, bank, row_h, W_out, p, n, False, stages=s), reps=5)
                for s in (1, 2, 3)] + [k_ms]
            for s, name in enumerate(("load + store", "pass 1",
                                      "exchange (two cluster syncs)",
                                      "pass 2")):
                prev = cut_ms[s - 1] if s else 0.0
                print(f"  split: {name}: {cut_ms[s] - prev:.3f} ms "
                      f"(cut after it: {cut_ms[s]:.3f} ms)")
            del W_out
        # --- unwrap_diff: the bare entry, and synsq_bins ---------------
        k_ms = cuda_ms(lambda: unwrap_diff(phb), reps=10)
        p_ms = cuda_ms(chunked(unwrap_diff_ref, (phb,), 8 * WAV_NUM), reps=3,
                       warmup=1)
        l_ms = cuda_ms(chunked(unwrap_diff_ref, (phb,), 8 * WAV_NUM), reps=3,
                       warmup=1)
        bare = kernel_row(
            "unwrap_diff", "unwrap_diff",
            "audioflux_tpu/ops/pallas_unwrap.py:102", launches["unwrap_diff"],
            errs["unwrap_diff"], k_ms, p_ms, l_ms, 8 * cells, 14.0 * cells,
            f"{band_rows}x{n}", entry="unwrap_diff")
        # the bins: about 60 fp32 operations a cell (atan2f and log2f
        # counted as their instructions), a reckoning; no one PyTorch call
        # computes them
        bins_ms = cuda_ms(lambda: synsq_bins(Wb, fre_t, "log", WAV_NUM,
                                             float(SR), sq.thresh), reps=10)
        p_ms = cuda_ms(chunked(lambda v: synsq_bins_ref(
            v, fre_t, "log", WAV_NUM, float(SR), sq.thresh), (Wb,), 8),
            reps=3, warmup=1)
        row = with_entries(kernel_row(
            "unwrap_diff", "unwrap_diff",
            "audioflux_tpu/ops/pallas_unwrap.py:102", launches["synsq_bins"],
            errs["synsq_bins"], bins_ms, p_ms, None, 12 * cells, 60.0 * cells,
            f"{clips}x{WAV_NUM}x{n} cells -> bins", entry="synsq_bins"),
            bare)
        if clips == WAV_CLIPS:
            rows.append(row)
            bins_128 = bins_ms
        # --- columnar_scatter ------------------------------------------
        k_ms = cuda_ms(lambda: columnar_scatter(Wb, fib, WAV_NUM), reps=10)
        if clips == WAV_CLIPS:
            scatter_128 = k_ms
        p_ms = cuda_ms(chunked(lambda v, f: columnar_scatter_ref(
            v, f, WAV_NUM), (Wb, fib), 8), reps=2, warmup=1)
        l_ms = cuda_ms(chunked(lib_scatter, (Wb, fib), 8), reps=3, warmup=1)
        row = kernel_row(
            "columnar_scatter", "columnar_scatter",
            "audioflux_tpu/ops/pallas_scatter.py:71",
            launches["columnar_scatter"], errs["columnar_scatter"], k_ms,
            p_ms, l_ms, (12 + 8) * cells, 2.0 * cells,
            f"{clips} x {WAV_NUM} -> {WAV_NUM} x {n}")
        if clips == WAV_CLIPS:
            rows.append(row)

    # --- the steps synsq_bins replaces (the force_xla_unwrap chain, with
    # the bare unwrap kernel in it), at 128 clips -------------------------
    e = unwrap_diff(ph).reshape(W.shape)
    two_pi = torch.tensor(2 * math.pi, dtype=torch.float32, device="cuda")

    def rate():
        return torch.cat([e[..., :-1], e[..., -2:-1]], dim=-1) / two_pi
    d = rate()
    th = torch.tensor(sq.thresh, dtype=torch.float32, device="cuda")

    def keep():
        ok = (fi >= 0) & (fi < WAV_NUM) & (W.real ** 2 + W.imag ** 2 > th * th)
        return torch.where(ok, fi, torch.full_like(fi, WAV_NUM))
    for name, fn in (
            ("cwt: symmetric pad + torch.fft.fft",
             lambda: torch.fft.fft(_symmetric_pad(x, p), dim=-1)),
            ("synsq: atan2", lambda: torch.atan2(W.real, W.imag)),
            ("synsq: last-column copy + / 2 pi", rate),
            ("synsq: bin map (abs, log2, floor, range, cast)",
             lambda: bin_map(d, fre_t, scale_kind="log", num=WAV_NUM,
                             samplate=float(SR))),
            ("synsq: power, threshold, drop bin", keep)):
        print(f"  the steps synsq_bins replaces, at {WAV_CLIPS} clips: "
              f"{name}: {cuda_ms(fn, reps=5, warmup=1):.3f} ms")
    del e, d, F, ph

    # --- the users' calls: audio-hours per second ------------------------
    for clips in (WAV_CLIPS, WAV_SMALL):
        xb, Wb = x[:clips], W[:clips]
        hours = clips * n / SR / 3600.0
        for name, fn in (
                ("CWT.cwt", lambda: cwt.cwt(xb)),
                ("Synsq.synsq", lambda: sq.synsq(Wb, OCTAVE, fre)),
                ("CWT.cwt -> Synsq.synsq",
                 lambda: sq.synsq(cwt.cwt(xb), OCTAVE, fre)),
                ("WSST.wsst", lambda: ws.wsst(xb)),
                ("PWT.pwt", lambda: pw.pwt(xb))):
            ms = cuda_ms(fn, reps=5, warmup=1)
            if (name, clips) == ("Synsq.synsq", WAV_CLIPS):
                synsq_ms = ms
            print(f"  {name} {clips}x{n}: {ms:.3f} ms, "
                  f"{hours / (ms / 1e3):.2f} audio-hours/s")
    for name, ms in (("synsq_bins", bins_128),
                     ("columnar_scatter", scatter_128),
                     ("the rest (the call less the two kernels)",
                      synsq_ms - bins_128 - scatter_128)):
        print(f"  split of Synsq.synsq at {WAV_CLIPS} clips: {name}: "
              f"{ms:.3f} ms")
    return rows


def fused_plan(bft, cc_num):
    """The fused kernel's plan that ``bft.bft_fused`` runs (built on the
    first call)."""
    return bft._fused_cache[max(cc_num, 1)]


def phase2_slice7_kernels(gen, errs):
    phase("phase 2 (slice 7): the new paths' kernel shapes and the "
          "resampler")
    # the fused kernel at config 1's shape (n_fft 1024, 513 LINEAR bands
    # as a 0/1 bank, slide 256, cc 1): clips of odd length, a 1-D view at
    # an offset of one float, one-frame clips
    bft = BFT(**C1_KW)
    n = 40 * 256 + 1024
    for label, x in (("3 clips of odd length", randn((3, n + 77), gen, 0.2)),
                     ("1-D view at offset 1", randn(n + 1, gen, 0.2)[1:]),
                     ("4 clips of one frame", randn((4, 1024), gen, 0.2))):
        bft.bft_fused(x, cc_num=1)
        torch.cuda.synchronize()
        mel, cc = fused_mel_mfcc(fused_plan(bft, 1), x)
        mel_r, cc_r = fused_mel_mfcc_ref(fused_plan(bft, 1), x.clone())
        for what, a, b in (("spec", mel, mel_r), ("cc", cc, cc_r)):
            check(f"fused 1024/256, 513 LINEAR bands, cc 1: {label} {what}",
                  rel_err(a, b), FP32_TOL)
    # fft_pow2 at n 4096 on the server reassignment rows (1000 clips x the
    # windows h and dh x one frame, real)
    rb = BFT(num=128, radix2_exp=C3_R2E, samplate=SR, slide_length=C3_SLIDE,
             scale_type=SpectralFilterBankScaleType.LINEAR,
             data_type=SpectralDataType.POWER, is_reassign=True)
    xs = randn((C3_CLIPS, C3_N), gen, 0.2)
    rows = reassign_rows(rb._re, xs, 2)
    abs_err, peak = pair_err(fft_fwd(rows), fft_fwd_ref(rows))
    check(f"fft_pow2 n=4096 on the reassignment rows {tuple(rows.shape)}",
          abs_err / peak, FFT_TOL)
    errs["fft_pow2 4096"] = abs_err
    # the resampler on the card against the port on the CPU: a TF32
    # product (about 1e-3 relative) fails this tolerance
    for (src, dst), qual, shape in (((2, 1), ResampleQualityType.FAST,
                                     (64, 4096)),
                                    ((32000, 22050), ResampleQualityType.BEST,
                                     (4, 9000)),
                                    ((999, 890), ResampleQualityType.MID,
                                     (4, 9000))):
        x = randn(shape, gen, 0.2)
        got = []
        for dev in ("cuda", "cpu"):
            rs = Resample(qual, is_scale=True, device=dev)
            rs.set_samplate(src, dst)
            got.append(rs.resample(x.to(dev)).cpu())
        check(f"resampler {src}:{dst} {qual.name} on the card vs the CPU",
              rel_err(*got), FP32_TOL)


def reassign_rows(re_plan, x, k):
    """The rows the reassignment transforms: frames times its first ``k``
    windows, (..., k, T, n) contiguous."""
    n = re_plan.fft_length
    frames = x.unfold(-1, n, re_plan.slide_length)
    return (frames[..., None, :, :]
            * re_plan._wins_t[:k, None, :]).contiguous()


def read_slice7_counts():
    counts = read_counts()
    counts["fused_mel_mfcc"] = fused_mel_mfcc.launches
    return counts


def zero_slice7_counts():
    zero_counts()
    fused_mel_mfcc.launches = 0


def run_counted(path, fn, required):
    """``fn()`` with the launch counts set to 0 just before it and read
    just after; each kernel in ``required`` must have launched."""
    zero_slice7_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = read_slice7_counts()
    require_launched(path, {k: counts[k] for k in required})
    return out, counts


def config5_stages(x, yin, mel, sp, hp, param):
    """Config 5's device part (bench.py:467-474): YIN, the mel flux
    envelope, HPSS."""
    fre, _ = yin.pitch(x)
    env = sp.flux(mel.spectrogram(x), step=param.step, p=param.p,
                  is_positive=bool(param.is_positive),
                  is_exp=bool(param.is_exp), tp=param.tp)
    h, p = hp.hpss(x)
    return fre, env, h, p


def onset_points(env, on):
    """Config 5's host stage (bench.py:476-483): each clip's envelope
    fetched, normalized and peak-picked."""
    points = []
    for row in env.cpu().numpy().astype(np.float32):
        row = row - row.min()
        mx = row.max()
        if mx > 0:
            row = row / mx
        points.append(peak_pick(row, on.pre_max, on.post_max, on.pre_avg,
                                on.post_avg, on.wait, on.delta))
    return points


def phase3_slice7_paths(gen, errs):
    phase("phase 3d: benchmark configurations 1, 3 and 5 at full size")
    cpu = {"device": "cpu"}
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    # --- config 1: BFT.bft_fused, 128 clips and 1024 --------------------
    n1 = C1_SECONDS * SR
    c1 = BFT(**C1_KW)
    c1.set_result_type(1)
    x1 = randn((C1_FULL, n1), gen, 0.2)
    xb = x1[:C1_CLIPS]
    torch.cuda.synchronize()
    spec, c = run_counted(f"config 1 (BFT.bft_fused, {C1_CLIPS} clips)",
                          lambda: c1.bft_fused(xb, cc_num=1)[0],
                          ("fused_mel_mfcc",))
    add(c)
    (spec_f, cc_f), c = run_counted(
        f"config 1 (BFT.bft_fused, {C1_FULL} clips)",
        lambda: c1.bft_fused(x1, cc_num=1), ("fused_mel_mfcc",))
    add(c)
    T1 = c1.cal_time_length(n1)
    for name, t, shape in (("spec", spec, (C1_CLIPS, 513, T1)),
                           ("spec x1024", spec_f, (C1_FULL, 513, T1)),
                           ("cc x1024", cc_f, (C1_FULL, 1, T1))):
        if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()):
            raise AssertionError(f"config 1 {name}: shape {tuple(t.shape)} "
                                 "or non-finite values")
    check(f"gate config 1: bft_fused vs the exact .bft() on the card (all "
          f"{C1_CLIPS} clips)", rel_err(spec, c1.bft(xb)), GATE_TOL)
    c1_cpu = BFT(**C1_KW, **cpu)
    c1_cpu.set_result_type(1)
    ends = [0, C1_CLIPS - 1]
    check("gate config 1: bft_fused vs .bft() on the CPU (first and last "
          "clip)", rel_err(spec[ends].cpu(), c1_cpu.bft(xb[ends].cpu())),
          GATE_TOL)
    # the spectrum against the plain version over both batches; the
    # cepstrum of single-bin (LINEAR) powers takes log10 of bins as small
    # as 1e-9 of the mean, where a rounding of the power is a large share
    # of the bin: it is held against the log-DCT of the kernel's own
    # spectrum (the stages after the power), its distance from the plain
    # version printed
    plan = fused_plan(c1, 1)
    for label, got, xx in ((f"{C1_CLIPS}", spec, xb),
                           (f"{C1_FULL}", spec_f, x1)):
        err = 0.0
        for lo in range(0, xx.shape[0], C1_CLIPS):
            ref = fused_mel_mfcc_ref(plan, xx[lo:lo + C1_CLIPS])[0]
            err = max(err, rel_err(got[lo:lo + C1_CLIPS], ref))
            del ref
        check(f"fused 1024/256, 513 bands: spectrum vs plain (all {label} "
              "clips)", err, FP32_TOL)
    err = plain = 0.0
    for lo in range(0, C1_FULL, C1_CLIPS):
        sl = slice(lo, lo + C1_CLIPS)
        own = torch.matmul(plan.dct, torch.log10(torch.clamp(spec_f[sl],
                                                             min=1e-8)))
        err = max(err, rel_err(cc_f[sl], own))
        plain = max(plain, rel_err(cc_f[sl], fused_mel_mfcc_ref(
            plan, x1[sl])[1]))
    print(f"  fused 1024/256, 513 bands: cc vs the plain version (all "
          f"{C1_FULL} clips): max err / peak = {plain:.3e}")
    check(f"fused 1024/256, 513 bands: cc vs the log-DCT of its own "
          f"spectrum (all {C1_FULL} clips)", err, FP32_TOL)
    del spec_f, cc_f

    # --- config 3, server rows: CQT, chroma, reassigned BFT --------------
    xs = randn((C3_CLIPS, C3_N), gen, 0.2)
    cq = CQT(num=84, samplate=SR, slide_length=C3_SLIDE)
    rb = BFT(num=128, radix2_exp=C3_R2E, samplate=SR, slide_length=C3_SLIDE,
             scale_type=SpectralFilterBankScaleType.LINEAR,
             data_type=SpectralDataType.POWER, is_reassign=True)
    torch.cuda.synchronize()
    C, c = run_counted("config 3 server CQT (top-octave FFT 512: no kernel)",
                       lambda: cq.cqt(xs).abs(), ())
    add(c)
    ch, c = run_counted("config 3 server chroma_linear",
                        lambda: chroma_linear(xs, chroma_num=12,
                                              radix2_exp=C3_R2E, samplate=SR,
                                              slide_length=C3_SLIDE),
                        ("fft_pow2", "fft_pow2 register route"))
    add(c)
    R, c = run_counted("config 3 server reassigned BFT",
                       lambda: rb.bft(xs, result_type=1),
                       ("fft_pow2", "fft_pow2 register route"))
    add(c)
    for name, t, shape in (("cqt", C, (C3_CLIPS, 84, 5)),
                           ("chroma", ch, (C3_CLIPS, 12, 1)),
                           ("reassign", R, (C3_CLIPS, 128, 1))):
        if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()):
            raise AssertionError(f"config 3 {name}: shape {tuple(t.shape)} "
                                 "or non-finite values")
    ends = list(range(8)) + list(range(C3_CLIPS - 8, C3_CLIPS))
    x_cpu = xs[ends].cpu()
    check("gate config 3 |cqt| (first and last 8 clips) vs CPU",
          rel_err(C[ends].cpu(), CQT(num=84, samplate=SR,
                                     slide_length=C3_SLIDE, **cpu)
                  .cqt(x_cpu).abs()), GATE_TOL)
    check("gate config 3 chroma_linear (first and last 8 clips) vs CPU",
          rel_err(ch[ends].cpu(), chroma_linear(
              x_cpu, chroma_num=12, radix2_exp=C3_R2E, samplate=SR,
              slide_length=C3_SLIDE, **cpu)), GATE_TOL)
    reassign_edge_gate(
        "gate config 3 reassigned BFT (first and last 8 clips) vs CPU",
        R[ends].cpu(), BFT(num=128, radix2_exp=C3_R2E, samplate=SR,
                           slide_length=C3_SLIDE,
                           scale_type=SpectralFilterBankScaleType.LINEAR,
                           data_type=SpectralDataType.POWER,
                           is_reassign=True, **cpu).bft(x_cpu, result_type=1),
        rb, xs[ends], x_cpu)
    rows_s = reassign_rows(rb._re, xs, 2)
    errs["fft_pow2 4096"] = max(errs["fft_pow2 4096"], whole_batch(
        f"fft_pow2 n=4096, all {rows_s.numel() >> C3_R2E} server "
        "reassignment rows vs plain", fft_fwd, fft_fwd_ref, (rows_s,), 250,
        FFT_TOL))

    # --- config 3, long: Reassign.reassign -> abs on 8 x 30 s ------------
    xl = randn((C3_LONG, C3_SECONDS * SR), gen, 0.2)
    rl = Reassign(radix2_exp=C3_R2E, samplate=SR, slide_length=C3_SLIDE)
    torch.cuda.synchronize()
    L, c = run_counted(f"config 3 long Reassign ({C3_LONG} x {C3_SECONDS} s)",
                       lambda: rl.reassign(xl).abs(),
                       ("fft_pow2", "fft_pow2 register route"))
    add(c)
    TL = rl.cal_time_length(xl.shape[-1])
    if tuple(L.shape) != (C3_LONG, 2049, TL) or not bool(
            torch.isfinite(L).all()):
        raise AssertionError(f"config 3 long: shape {tuple(L.shape)} or "
                             "non-finite values")
    ends = [0, C3_LONG - 1]
    flips_and_mass("gate config 3 long |reassign| (first and last clip) vs "
                   "CPU", L[ends].cpu(),
                   Reassign(radix2_exp=C3_R2E, samplate=SR,
                            slide_length=C3_SLIDE, **cpu)
                   .reassign(xl[ends].cpu()).abs(), RE_FLIP_TOL)
    rows_l = reassign_rows(rl, xl, 3)
    errs["fft_pow2 4096"] = max(errs["fft_pow2 4096"], whole_batch(
        f"fft_pow2 n=4096, all {rows_l.numel() >> C3_R2E} long reassignment "
        "rows vs plain", fft_fwd, fft_fwd_ref, (rows_l,), 1, FFT_TOL))
    del rows_l

    # --- config 5: YIN + mel flux onsets + HPSS on 8 x 30 s ---------------
    n5 = MIR_SECONDS * SR
    x5 = mir_signal(MIR_SMALL, n5, gen)
    yin = PitchYIN(samplate=SR, radix2_exp=YIN_R2E, slide_length=YIN_SLIDE)
    hp = HPSS(radix2_exp=R2E, window_type=WindowType.HAMM, slide_length=SLIDE,
              h_order=H_ORDER, p_order=P_ORDER)
    mel = MelSpectrogram(num=NUM, samplate=SR, radix2_exp=R2E,
                         slide_length=SLIDE)
    sp = Spectral(NUM, np.zeros(NUM, np.float32))
    param = NoveltyParam()
    on = Onset(time_length=1, fre_length=NUM, slide_length=SLIDE, samplate=SR)
    torch.cuda.synchronize()
    (fre, env, h, p), c = run_counted(
        f"config 5 (YIN + mel flux + HPSS, {MIR_SMALL} x {MIR_SECONDS} s)",
        lambda: config5_stages(x5, yin, mel, sp, hp, param),
        ("fft_pow2", "fft_pow2 register route", "fft_inv",
         "fft_autocorr_yin", "median_filter"))
    add(c)
    points = onset_points(env, on)
    Te = mel.cal_time_length(n5)
    if tuple(env.shape) != (MIR_SMALL, Te) or not bool(
            torch.isfinite(env).all()):
        raise AssertionError(f"config 5 envelope: shape {tuple(env.shape)} "
                             "or non-finite values")
    mel_c = MelSpectrogram(num=NUM, samplate=SR, radix2_exp=R2E,
                           slide_length=SLIDE, **cpu)
    sp_c = Spectral(NUM, np.zeros(NUM, np.float32), **cpu)
    env_c = sp_c.flux(mel_c.spectrogram(x5.cpu()), step=param.step,
                      p=param.p, is_positive=bool(param.is_positive),
                      is_exp=bool(param.is_exp), tp=param.tp)
    check(f"gate config 5 flux envelope (all {MIR_SMALL} clips) vs CPU",
          rel_err(env.cpu(), env_c), GATE_TOL)
    points_c = onset_points(env_c, on)
    differ = sum(len(set(a.tolist()) ^ set(b.tolist()))
                 for a, b in zip(points, points_c))
    total = sum(len(b) for b in points_c)
    print(f"  gate config 5 onset frames vs CPU: {differ} of {total} differ "
          f"(<= {ONSET_SHARE:.0%}); per clip "
          f"{[len(a) for a in points]} on the card, "
          f"{[len(b) for b in points_c]} on the CPU")
    if total == 0 or differ > ONSET_SHARE * total:
        raise AssertionError(f"config 5 onsets: {differ} of {total} differ")
    ends = [0, MIR_SMALL - 1]
    hpss_yin_gates("config 5, first and last clip", x5[ends], h[ends],
                   p[ends], yin)

    # --- CQT on the kernel tier: num=24 from C1, top-octave FFT 16384 -----
    cq24 = CQT(num=24, samplate=SR)
    if cq24.fft_length != 16384:
        raise AssertionError(f"CQT(num=24) fft_length {cq24.fft_length}")
    xq = randn((16, SR), gen, 0.2)
    torch.cuda.synchronize()
    Cq, c = run_counted("CQT(num=24), FFT 16384", lambda: cq24.cqt(xq),
                        ("fft_pow2",))
    add(c)
    e, pk = complex_err(Cq.cpu(), CQT(num=24, samplate=SR, **cpu)
                        .cqt(xq.cpu()))
    check("gate CQT(num=24) (16 clips of 1 s) vs CPU", e / pk, GATE_TOL)
    print(f"  launches on the slice-7 paths: {launches}")
    return dict(c1=c1, x1=x1, cq=cq, rb=rb, xs=xs, rows_s=rows_s, rl=rl,
                xl=xl, x5=x5, yin=yin, hp=hp, mel=mel, sp=sp, param=param,
                on=on, cq24=cq24, xq=xq, launches=launches)


def phase4_slice7_timing(d, errs):
    phase("phase 4d: configurations 1, 3 and 5 timing (CUDA events, median)")
    shapes = {}
    # --- the fused kernel at config 1's shape ----------------------------
    c1, x1 = d["c1"], d["x1"]
    plan = fused_plan(c1, 1)
    n1 = x1.shape[1]
    T1 = c1.cal_time_length(n1)
    nfft = c1.fft_length
    for clips in (C1_CLIPS, C1_FULL):
        xb = x1[:clips]
        k_ms = cuda_ms(lambda: fused_mel_mfcc(plan, xb), reps=10)
        p_ms = cuda_ms(chunked(lambda t: fused_mel_mfcc_ref(plan, t), (xb,),
                               C1_CLIPS), reps=3, warmup=1)
        chunks = torch.split(xb, 32)
        frames_w = [(t.unfold(-1, nfft, plan.slide) * plan.window)
                    .contiguous() for t in chunks]

        def library():
            for f in frames_w:
                s = torch.fft.rfft(f, dim=-1)
                mel = torch.matmul(s.real.square() + s.imag.square(),
                                   plan.mel_fb.T)
                torch.matmul(torch.log10(torch.clamp(mel, min=1e-8)),
                             plan.dct.T)
        l_ms = cuda_ms(library, reps=3, warmup=1)
        del frames_w
        frames = clips * T1
        row = kernel_row(
            "fused_mel_mfcc", "fused_mel_mfcc",
            "audioflux_tpu/ops/pallas_spectrogram.py:1250",
            d["launches"]["fused_mel_mfcc"], errs["fused_mel_mfcc"], k_ms,
            p_ms, l_ms, 4 * (clips * n1 + clips * (513 + 1) * T1),
            frames * (2.5 * nfft * math.log2(nfft) + 2 * plan.band_nnz
                      + 513 + 2 * 513),
            f"config 1: {clips} x {n1}, n_fft 1024, 513 LINEAR bands, cc 1")
        shapes.setdefault("fused_mel_mfcc", []).append(dict(
            shape=f"{clips}x{n1} n_fft 1024 slide 256 513 bands cc 1",
            **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")}))
        e2e = cuda_ms(lambda: c1.bft_fused(xb, cc_num=1)[0], reps=10)
        hours = clips * n1 / SR / 3600.0
        print(f"  config 1 BFT.bft_fused {clips} x {C1_SECONDS} s: {e2e:.3f} "
              f"ms, {hours / (e2e / 1e3):.1f} audio-hours/s (outside the "
              f"kernel: {e2e - k_ms:.3f} ms)")
    xb = x1[:C1_CLIPS]
    # the kernel cut after each stage at config 1's shape: the differences
    # split its time
    cut_ms = [cuda_ms(lambda s=s: _launch(plan, xb, T1, stages=s), reps=10)
              for s in (1, 2, 3, 4)]
    for s, name in enumerate(("span load + window + first pass",
                              "second pass + power",
                              "filterbank + log10 (513 bands)", "DCT")):
        prev = cut_ms[s - 1] if s else 0.0
        print(f"  split (config 1, {C1_CLIPS} clips): {name}: "
              f"{cut_ms[s] - prev:.3f} ms (cut after it: {cut_ms[s]:.3f} ms)")
    ex = cuda_ms(lambda: c1.bft(xb), reps=5, warmup=1)
    print(f"  config 1 exact BFT.bft {C1_CLIPS} x {C1_SECONDS} s: {ex:.3f} ms")
    del d["x1"], x1, xb

    # --- fft_pow2 at n 4096 on the reassignment rows -----------------------
    rows_s = d["rows_s"]
    rows_l = reassign_rows(d["rl"], d["xl"], 3)
    for label, rows in (("server reassignment rows", rows_s),
                        ("long reassignment rows", rows_l)):
        nrows = rows.numel() >> C3_R2E
        n = 1 << C3_R2E
        k_ms = cuda_ms(lambda: fft_fwd(rows), reps=10)
        p_ms = cuda_ms(chunked(fft_fwd_ref, (rows,), 250), reps=3, warmup=1)
        l_ms = cuda_ms(chunked(lambda t: torch.fft.fft(t, dim=-1), (rows,),
                               250), reps=3, warmup=1)
        row = kernel_row(
            "fft_pow2", "fft_pow2", "audioflux_tpu/ops/pallas_fft.py:346",
            d["launches"]["fft_pow2"], errs["fft_pow2 4096"], k_ms, p_ms,
            l_ms, 12 * rows.numel(), nrows * 5.0 * n * math.log2(n),
            f"forward {nrows}x{n} real ({label})")
        shapes.setdefault("fft_pow2", []).append(dict(
            shape=f"{nrows}x{n} real, {label}",
            **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")}))
    del rows_l

    # --- the users' calls: audio-hours per second --------------------------
    xs, cq, rb = d["xs"], d["cq"], d["rb"]
    hours = xs.numel() / SR / 3600.0
    for name, fn in (("abs(CQT.cqt)", lambda: cq.cqt(xs).abs()),
                     ("chroma_linear", lambda: chroma_linear(
                         xs, chroma_num=12, radix2_exp=C3_R2E, samplate=SR,
                         slide_length=C3_SLIDE)),
                     ("reassigned BFT.bft", lambda: rb.bft(xs,
                                                           result_type=1))):
        ms = cuda_ms(fn, reps=10)
        print(f"  config 3 server {name} {C3_CLIPS} x {C3_N}: {ms:.3f} ms, "
              f"{hours / (ms / 1e3):.1f} audio-hours/s")
        if name == "abs(CQT.cqt)":
            cqt_ms = ms
    # where abs(CQT.cqt)'s time goes: the resampling chain, the octaves'
    # padded transforms and kernel products, the rest
    octave_in = [xs]
    for _ in range(cq.octave_num - 1):
        octave_in.append(cq._resampler.resample(octave_in[-1]))

    def chain():
        y = xs
        for _ in range(cq.octave_num - 1):
            y = cq._resampler.resample(y)

    def octaves():
        for i in range(cq.octave_num):
            cq._octave_spec(octave_in[cq.octave_num - 1 - i],
                            C3_SLIDE >> (cq.octave_num - 1 - i),
                            cq._kernels_t[i])
    chain_ms = cuda_ms(chain, reps=10)
    oct_ms = cuda_ms(octaves, reps=10)
    for name, ms in ((f"the resampling chain ({cq.octave_num - 1} x 2:1)",
                      chain_ms),
                     (f"the {cq.octave_num} octaves (pad, frames, FFT 512, "
                      "kernel products)", oct_ms),
                     ("the rest (concatenation, scale, abs)",
                      cqt_ms - chain_ms - oct_ms)):
        print(f"  split of abs(CQT.cqt) at {C3_CLIPS} clips: {name}: "
              f"{ms:.3f} ms")
    del octave_in
    xl, rl = d["xl"], d["rl"]
    ms = cuda_ms(lambda: rl.reassign(xl).abs(), reps=5, warmup=1)
    hours = xl.numel() / SR / 3600.0
    print(f"  config 3 long Reassign.reassign -> abs {C3_LONG} x "
          f"{C3_SECONDS} s: {ms:.3f} ms, {hours / (ms / 1e3):.2f} "
          "audio-hours/s")
    x5, yin, mel, sp, hp, param, on = (d[k] for k in (
        "x5", "yin", "mel", "sp", "hp", "param", "on"))
    hours = x5.numel() / SR / 3600.0
    dev_ms = cuda_ms(lambda: config5_stages(x5, yin, mel, sp, hp, param),
                     reps=5, warmup=1)
    env = config5_stages(x5, yin, mel, sp, hp, param)[1]
    torch.cuda.synchronize()
    host = []
    for _ in range(5):
        t0 = time.perf_counter()
        onset_points(env, on)
        host.append((time.perf_counter() - t0) * 1e3)
    host_ms = sorted(host)[2]
    for name, fn in (("PitchYIN.pitch", lambda: yin.pitch(x5)),
                     ("mel .spectrogram() -> Spectral.flux", lambda: sp.flux(
                         mel.spectrogram(x5), step=param.step, p=param.p,
                         is_positive=bool(param.is_positive),
                         is_exp=bool(param.is_exp), tp=param.tp)),
                     ("HPSS.hpss", lambda: hp.hpss(x5))):
        print(f"  config 5 stage {name} {MIR_SMALL} x {MIR_SECONDS} s: "
              f"{cuda_ms(fn, reps=5, warmup=1):.3f} ms")
    print(f"  config 5 device part (YIN + mel flux + HPSS) {MIR_SMALL} x "
          f"{MIR_SECONDS} s: {dev_ms:.3f} ms, {hours / (dev_ms / 1e3):.2f} "
          f"audio-hours/s; host stage (fetch + peak-pick, host clock): "
          f"{host_ms:.3f} ms; both in turn: {dev_ms + host_ms:.3f} ms, "
          f"{hours / ((dev_ms + host_ms) / 1e3):.2f} audio-hours/s")
    cq24, xq = d["cq24"], d["xq"]
    ms = cuda_ms(lambda: cq24.cqt(xq), reps=10)
    print(f"  CQT(num=24) (FFT 16384) 16 x 1 s: {ms:.3f} ms, "
          f"{xq.numel() / SR / 3600.0 / (ms / 1e3):.2f} audio-hours/s")
    return shapes


def merge_slice7(rows, launches, shapes):
    """The kernels line's rows gain the slice-7 paths' launches, and the
    fused kernel's and fft_pow2's rows their readings at the new shapes
    (under ``shapes``; the top-level keys keep the earlier paths' shape)."""
    extra = {"fused_mel_mfcc": launches.get("fused_mel_mfcc", 0),
             "fft_pow2": launches.get("fft_pow2", 0),
             "fft_inv": launches.get("fft_inv", 0),
             "fft_autocorr": launches.get("fft_autocorr_yin", 0),
             "median_filter": launches.get("median_filter", 0)}
    for row in rows:
        row["launches"] += extra.get(row["name"], 0)
        for e in row.get("entries", ()):
            e["launches"] += launches.get(e["entry"], 0)
        if row["name"] in shapes:
            row["shapes"] = shapes[row["name"]]
    return rows


def fe_signal(n_clips, n, gen):
    """(n_clips, n) test audio: per clip two tones at seeded random
    frequencies (50 Hz .. 12 kHz) plus noise."""
    t = torch.arange(n, device="cuda", dtype=torch.float32) / SR
    f = 50.0 + 12000.0 * torch.rand((2, n_clips, 1), generator=gen,
                                    device="cuda")
    x = (0.4 * torch.sin(2 * math.pi * f[0] * t)
         + 0.2 * torch.sin(2 * math.pi * f[1] * t))
    return x + randn((n_clips, n), gen, 0.05)


def st_rows(plan, x):
    """The rows ST's inverse transforms: per bin the shifted spectrum
    times its window, as (re, im), each (clips, nbins, L) contiguous."""
    F = torch.fft.fft(x, dim=-1)
    return tuple(torch.cat([part, part], dim=-1)[..., plan._idx_t]
                 .mul_(plan._w_t) for part in (F.real, F.imag))


def deep_rows(plan, x):
    """The rows Deep's forward transforms: frames times its window."""
    return (x.unfold(-1, plan.fft_length, plan.slide_length)
            * plan._window_t).contiguous()


def read_path_counts():
    """Every counter a later slice's paths read: the phase-3 counters (the
    FFT's routes among them) and the wavelet kernel's."""
    counts = read_counts()
    counts["cwt_ifft_bank"] = cwt_ifft_bank.launches
    return counts


def zero_path_counts():
    zero_counts()
    cwt_ifft_bank.launches = 0


def count_call(label, fn, required, reckoned_gb, launches, forbidden=()):
    """``fn()`` with the launch counts set to 0 just before and read just
    after; each kernel in ``required`` must have launched, none in
    ``forbidden``.  The peak device memory of the call (what the phase
    holds included) is printed beside the bytes reckoned beforehand and
    held under MEM_LIMIT_GB; the counts are added to ``launches``.
    Returns (fn's result, the counts)."""
    zero_path_counts()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    counts = read_path_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    ran = {k: v for k, v in counts.items() if v}
    print(f"  {label}: peak device memory {peak:.2f} GB (reckoned "
          f"{reckoned_gb:.2f} GB); launches {ran}")
    require_launched(label, {k: counts[k] for k in required})
    for k in forbidden:
        if counts[k]:
            raise AssertionError(f"{label} launched {k}: {counts}")
    if peak > MEM_LIMIT_GB:
        raise AssertionError(f"{label}: {peak:.2f} GB > {MEM_LIMIT_GB}")
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    return out, counts


def gate_err(got, ref):
    """max |got - ref| over the peak of |ref|, complex or real, in float64
    on the CPU."""
    got, ref = got.cpu(), ref.cpu()
    if got.is_complex():
        e, pk = complex_err(got.to(torch.complex128),
                            ref.to(torch.complex128))
        return e / pk
    return rel_err(got, ref)


def deconv_pitch64(mag):
    """Deconv's pitch part of a (..., num, T) magnitude spectrogram in
    float64 on the CPU (features/deconv.py's definition)."""
    num = mag.shape[-2]
    L = 1 << (2 * num - 1).bit_length()
    F = torch.fft.fft(mag.double().transpose(-1, -2), n=L, dim=-1)
    white = F / torch.clamp(F.abs(), min=1e-16)
    return torch.fft.ifft(white, dim=-1).real[..., :num].transpose(-1, -2)


def phase2_slice8_kernels(gen):
    phase("phase 2e: the FFT kernels at slice 8's shapes against their "
          "plain versions, over the whole batch")
    st = ST(radix2_exp=FE_R2E, samplate=SR)
    n = st.fft_length
    re, im = st_rows(st, fe_signal(FE_CLIPS, n, gen))
    what = (f"{re.numel() // n} rows of {n} (ST's inverse rows, {FE_CLIPS} "
            "clips)")
    whole_batch(
        f"fft_pow2 complex, {what}", fft_fwd, fft_fwd_ref, (re, im), 4,
        FFT_TOL)
    whole_batch(
        f"fft_inv, {what}", fft_inv, fft_inv_ref, (re, im), 4, FFT_TOL)
    del re, im
    deep = DeepSpectrogram(num=84, radix2_exp=FE_R2E, samplate=SR)
    rows = deep_rows(deep, mir_signal(MIR_SMALL, MIR_SECONDS * SR, gen))
    whole_batch(
        f"fft_pow2 real, {rows.numel() // n} rows of {n} (Deep's frames, "
        f"{MIR_SMALL} x {MIR_SECONDS} s)", fft_fwd, fft_fwd_ref, (rows,), 1,
        FFT_TOL)


def phase3_slice8_paths(gen):
    phase("phase 3e: slice 8 at full width (FeatureExtractor's nine "
          "transforms, Deep, Cepstrogram, the DSP calls)")
    cpu = {"device": "cpu"}
    launches = {}

    def counted(label, fn, required, reckoned_gb):
        return count_call(label, fn, required, reckoned_gb, launches)

    def finite(label, t, shape=None):
        if (shape is not None and tuple(t.shape) != shape) or not bool(
                torch.isfinite(t).all()):
            raise AssertionError(f"{label}: shape {tuple(t.shape)} or "
                                 "non-finite values")

    # --- FeatureExtractor: the nine transforms on 64 clips of 4096 -------
    L = 1 << FE_R2E
    x = fe_signal(FE_CLIPS, L, gen)
    fe = FeatureExtractor(list(FE_NAMES), radix2_exp=FE_R2E, samplate=SR)
    st = fe._objs["st"]
    nb = len(st.bin_arr)
    # the results: ST and FST complex (clips, ~L/2, L), WPT real (clips,
    # L/2, L), CWT and PWT complex (clips, 84, L); ST's inverse holds its
    # two input parts, its two output parts and the complex result at once
    # (3 x its result), after the CWT's and PWT's results
    st_gb = FE_CLIPS * nb * L * 8 / 1e9
    wav_gb = 2 * FE_CLIPS * 84 * L * 8 / 1e9
    held_gb = 2 * st_gb + st_gb / 2 + wav_gb
    torch.cuda.synchronize()
    r, _ = counted(f"FeatureExtractor.spectrogram, nine transforms, "
                   f"{FE_CLIPS} x {L}", lambda: fe.spectrogram(x),
                   ("fft_pow2", "fft_inv", "fft_inv row route"),
                   max(held_gb, 3 * st_gb + wav_gb))
    for name in FE_NAMES:
        finite(f"3e {name}", r[name]["spectrogram"])
    # each transform alone: ST launches both FFT kernels, FST and NSGT the
    # forward; CWT and PWT pad 4096 to 8192, below cwt_ifft_bank's 2^14,
    # and run the forward and the inverse FFT kernels instead, the inverse
    # of complex rows at 8192 on the row route
    required = {"st": ("fft_pow2", "fft_inv"), "fst": ("fft_pow2",),
                "nsgt": ("fft_pow2",),
                "cwt": ("fft_pow2", "fft_inv", "fft_inv row route"),
                "pwt": ("fft_pow2", "fft_inv", "fft_inv row route"),
                "bft": ("fft_pow2",)}
    for name in FE_NAMES:
        out, c = counted(f"{name} alone", lambda name=name: fe._run_one(
            name, fe._objs[name], x), required.get(name, ()),
            held_gb + (3 * st_gb if name == "st" else 0.0))
        del out
    ends = [0, FE_CLIPS - 1]
    fe_cpu = FeatureExtractor(list(FE_NAMES), radix2_exp=FE_R2E,
                              samplate=SR, **cpu)
    rc = fe_cpu.spectrogram(x[ends].cpu())
    for name in FE_NAMES:
        tol = FP32_TOL if name in ("dwt", "wpt") else GATE_TOL
        check(f"gate 3e {name} (first and last clip) vs CPU",
              gate_err(r[name]["spectrogram"][ends], rc[name]["spectrogram"]),
              tol)
    # spectral flux over every result; against the CPU at 1e-4 of num *
    # peak^2, the scale of its summed squared differences
    sp, _ = counted("FeatureExtractor.spectral(flux), nine results",
                    lambda: fe.spectral(r, "flux"), (), held_gb + st_gb)
    rcp = {k: {"spectrogram": v["spectrogram"]} for k, v in rc.items()}
    sp_c = fe_cpu.spectral(rcp, "flux")
    for name in FE_NAMES:
        finite(f"3e flux {name}", sp[name]["flux"])
        mag = rc[name]["spectrogram"].abs()
        scale = mag.shape[-2] * float(mag.max()) ** 2
        err = float((sp[name]["flux"][ends].cpu() - sp_c[name]["flux"])
                    .abs().max()) / scale
        check(f"gate 3e flux {name} (first and last clip) vs CPU, of num * "
              "peak^2", err, GATE_TOL)
    # xxcc over every result with 13 coefficients; DWT has radix2_exp - 1
    # = 11 bands, and XXCC takes at most as many coefficients as bands (in
    # both packages), so DWT's gets 11.  The log10 of cells near its 1e-8
    # floor spreads a rounding over the DCT: 1e-3 of the peak
    cc_of = {k: (CC_NUM if r[k]["spectrogram"].shape[-2] >= CC_NUM
                 else r[k]["spectrogram"].shape[-2]) for k in FE_NAMES}

    def xxcc_all(fx, res):
        out = {}
        for k in FE_NAMES:
            out.update(fx.xxcc({k: res[k]}, cc_of[k]))
        return out
    cc, _ = counted(f"FeatureExtractor.xxcc (cc {cc_of}), nine results",
                    lambda: xxcc_all(fe, r), (), held_gb + st_gb)
    cc_c = xxcc_all(fe_cpu, rcp)
    for name in FE_NAMES:
        finite(f"3e xxcc {name}", cc[name]["xxcc"])
        check(f"gate 3e xxcc {name} (first and last clip) vs CPU",
              gate_err(cc[name]["xxcc"][ends], cc_c[name]["xxcc"]), 1e-3)
    del sp, cc
    # deconv on the first 8 clips' results (ST's 2048 bands: an FFT of
    # 4096 a frame); the timbre against the CPU on clips 0 and 7 at 1e-4.
    # The pitch, the inverse of the whitened spectrum F / |F|, turns the
    # rounding of bins near zero into whole unit vectors: float32 on the
    # CPU is ~5e-4 of the peak from float64 on ST's band vectors.  So it
    # is held against the float64 deconvolution of the card's own
    # spectrogram, within 4x the CPU port's float32 distance from it (and
    # at least 1e-4); its distance from the CPU port's is printed
    r8 = {k: {"spectrogram": v["spectrogram"][:FE_DECONV]}
          for k, v in r.items()}
    dc, _ = counted(f"FeatureExtractor.deconv, first {FE_DECONV} clips",
                    lambda: fe.deconv(r8), ("fft_pow2", "fft_inv"),
                    held_gb + 5 * FE_DECONV * L * L * 8 / 1e9)
    e8 = [0, FE_DECONV - 1]
    dc_c = fe_cpu.deconv({k: {"spectrogram": v["spectrogram"][e8].cpu()}
                          for k, v in r8.items()})
    for name in FE_NAMES:
        finite(f"3e deconv {name} timbre", dc[name]["timbre"])
        finite(f"3e deconv {name} pitch", dc[name]["pitch"])
        check(f"gate 3e deconv {name} timbre (clips 0 and "
              f"{FE_DECONV - 1}) vs CPU",
              gate_err(dc[name]["timbre"][e8], dc_c[name]["timbre"]),
              GATE_TOL)
        mag = r8[name]["spectrogram"][e8].abs().cpu()
        ref = deconv_pitch64(mag)
        own = gate_err(Deconv(num=mag.shape[-2], **cpu).deconv(mag)[1], ref)
        print(f"  deconv {name} pitch (clips 0 and {FE_DECONV - 1}) vs "
              f"CPU: {gate_err(dc[name]['pitch'][e8], dc_c[name]['pitch']):.3e}"
              f" of the peak; the CPU's float32 vs float64: {own:.3e}")
        check(f"gate 3e deconv {name} pitch (clips 0 and {FE_DECONV - 1}) "
              "vs float64 on the card's spectrogram",
              gate_err(dc[name]["pitch"][e8], ref), max(4 * own, GATE_TOL))
    del r, r8, dc, rc, rcp, fe_cpu
    # SWT (not in the extractor) on the same clips, 5 levels
    swt = SWT(num=5, fft_length=L)
    (sa, sd), _ = counted(f"SWT(num=5).swt, {FE_CLIPS} x {L}",
                          lambda: swt.swt(x), (),
                          2 * FE_CLIPS * 5 * L * 4 / 1e9)
    swt_c = SWT(num=5, fft_length=L, **cpu).swt(x[ends].cpu())
    for got, ref, what in ((sa, swt_c[0], "approx"), (sd, swt_c[1],
                                                      "detail")):
        check(f"gate 3e SWT {what} (first and last clip) vs CPU",
              gate_err(got[ends], ref), FP32_TOL)
    del sa, sd
    torch.cuda.empty_cache()

    # --- Deep and Cepstrogram on config 5's 8 x 30 s -------------------
    x5 = mir_signal(MIR_SMALL, MIR_SECONDS * SR, gen)
    deep1 = DeepSpectrogram(num=84, radix2_exp=FE_R2E, samplate=SR)
    deep4 = DeepSpectrogram(num=84, radix2_exp=FE_R2E, samplate=SR)
    deep4.set_deep_order(4)
    chroma = DeepChromaSpectrogram(radix2_exp=FE_R2E, samplate=SR)
    cep = Cepstrogram(radix2_exp=FE_R2E, samplate=SR)
    T5 = deep1.cal_time_length(x5.shape[-1])
    # Deep: about 16 maps of (frames, L/2 + 1) at 8 bytes (the spectrum
    # pair, masks, sort keys, running max, scatter indices); Cepstrogram:
    # about 7 complex (frames, L) tiles
    cells_gb = MIR_SMALL * T5 * (L // 2 + 1) * 8 / 1e9
    tile_gb = MIR_SMALL * T5 * L * 8 / 1e9
    e5 = [0, MIR_SMALL - 1]
    x5c = x5[e5].cpu()
    for label, plan, deep in (("DeepSpectrogram order 1", deep1, True),
                              ("DeepSpectrogram order 4", deep4, True),
                              ("DeepChromaSpectrogram", chroma, True)):
        out, _ = counted(f"{label}, {MIR_SMALL} x {MIR_SECONDS} s",
                         lambda plan=plan: plan.spectrogram(x5),
                         ("fft_pow2",), 16 * cells_gb)
        finite(f"3e {label}", out)
        ref = type(plan)(radix2_exp=FE_R2E, samplate=SR, **cpu)
        ref.set_deep_order(plan.deep_order)
        flips_and_mass(f"gate 3e {label} (first and last clip) vs CPU",
                       out[e5].cpu(), ref.spectrogram(x5c))
        del out
    ceps, c = counted(f"Cepstrogram, {MIR_SMALL} x {MIR_SECONDS} s "
                      "(torch.fft by design)", lambda: cep.cepstrogram(x5),
                      (), 7 * tile_gb)
    if c["fft_pow2"] or c["fft_inv"]:
        raise AssertionError(f"Cepstrogram launched an FFT kernel: {c}")
    ceps_c = Cepstrogram(radix2_exp=FE_R2E, samplate=SR,
                         **cpu).cepstrogram(x5c)
    for got, ref, what, tol in zip(ceps, ceps_c, ("cepstrum", "envelope",
                                                  "details"),
                                   (GATE_TOL, GATE_TOL, 1e-3)):
        finite(f"3e cepstrogram {what}", got)
        check(f"gate 3e Cepstrogram {what} (first and last clip) vs CPU",
              gate_err(got[e5], ref), tol)
    del ceps

    # --- the DSP calls: config 3's 1000 server clips, the phase vocoder --
    xs = randn((C3_CLIPS, C3_N), gen, 0.2)
    ys = xs.roll(1, dims=0)
    e3 = [0, C3_CLIPS - 1]
    dsp = (("hilbert", lambda: hilbert(xs), lambda: hilbert(xs[e3].cpu(),
                                                             **cpu)),
           ("xcorr", lambda: xcorr(xs, ys)[0], lambda: xcorr(
               xs[e3].cpu(), ys[e3].cpu(), **cpu)[0]),
           ("czt", lambda: czt(xs, 0.1, 0.3), lambda: czt(
               xs[e3].cpu(), 0.1, 0.3, **cpu)))
    for name, fn, ref_fn in dsp:
        # about ten complex (clips, 8192) rows: the two spectra, their
        # product, the inverse's parts and the result; xcorr's forwards
        # read the live span and its inverse takes the half spectrum
        need = ("fft_pow2", "fft_inv") + (
            ("fft_pow2 live span", "fft_inv half spectrum")
            if name == "xcorr" else ()) + (
            ("fft_pow2 row route", "fft_inv row route")
            if name == "czt" else ())
        out, _ = counted(f"{name}, {C3_CLIPS} x {C3_N}", fn, need,
                         C3_CLIPS * 2 * C3_N * 80 / 1e9)
        finite(f"3e {name}", out)
        check(f"gate 3e {name} (first and last clip) vs CPU",
              gate_err(out[e3], ref_fn()), GATE_TOL)
        del out
    stft = STFT(radix2_exp=R2E, window_type=WindowType.HANN,
                slide_length=PV_SLIDE)
    D = stft.stft(x5)
    pv, _ = counted(f"phase_vocoder(STFT(2048, HANN, 512).stft, 512, "
                    f"{PV_RATE}), {MIR_SMALL} x {MIR_SECONDS} s",
                    lambda: phase_vocoder(D, PV_SLIDE, PV_RATE), (),
                    D.numel() * 8 * 10 / 1e9)
    finite("3e phase vocoder", pv)
    pv_c = phase_vocoder(D[e5].cpu(), PV_SLIDE, PV_RATE, **cpu)
    check("gate 3e phase vocoder magnitudes (first and last clip) vs CPU",
          gate_err(pv[e5].abs(), pv_c.abs()), GATE_TOL)
    print(f"  phase vocoder complex output vs CPU (first and last clip): "
          f"max err / peak = {gate_err(pv[e5], pv_c):.3e} (printed, not "
          "gated: the phase adds up to ~pi * 512 * T)")
    del pv
    print(f"  launches on the slice-8 paths: "
          f"{ {k: v for k, v in launches.items() if v} }")
    return dict(fe=fe, x=x, x5=x5, xs=xs, ys=ys, deep1=deep1, deep4=deep4,
                chroma=chroma, cep=cep, D=D, launches=launches)


def phase4_slice8_timing(d):
    phase("phase 4e: slice 8 timing (CUDA events, median)")
    shapes = {}
    fe, x, x5, xs, ys = (d[k] for k in ("fe", "x", "x5", "xs", "ys"))
    hours = x.numel() / SR / 3600.0
    ms = cuda_ms(lambda: fe.spectrogram(x), reps=5, warmup=1)
    print(f"  FeatureExtractor.spectrogram, nine transforms, {FE_CLIPS} x "
          f"{x.shape[-1]}: {ms:.3f} ms, {hours / (ms / 1e3):.3f} "
          "audio-hours/s")
    for name in FE_NAMES:
        obj = fe._objs[name]
        ms = cuda_ms(lambda: fe._run_one(name, obj, x), reps=5, warmup=1)
        print(f"  {name} alone, {FE_CLIPS} x {x.shape[-1]}: {ms:.3f} ms")

    def shape_row(name, fn, ref, lib, tensors, chunk, n_bytes, n_rows, n,
                  what, lib_real=None):
        """One entry of the kernel's ``shapes``: its error against the
        plain version over these rows, kernel, plain, library and bound;
        ``lib_real`` (``torch.fft.rfft`` or ``irfft`` where it gives the
        same values) is timed beside the library call.  A real-row route
        row (``lib_real`` given) counts half a complex transform's
        operations."""
        err = whole_batch(f"{name} {what} vs plain", fn, ref, tensors, chunk,
                          FFT_TOL)
        k_ms = cuda_ms(lambda: fn(*tensors), reps=10)
        p_ms = cuda_ms(chunked(ref, tensors, chunk), reps=3, warmup=1)
        l_ms = cuda_ms(lib, reps=5, warmup=1)
        ops = n_rows * 5.0 * n * math.log2(n) / (1 if lib_real is None else 2)
        row = kernel_row(name, "fft_pow2", "audioflux_tpu/ops/pallas_fft.py:"
                         + ("346" if name == "fft_pow2" else "360"), 0, err,
                         k_ms, p_ms, l_ms, n_bytes, ops, what)
        entry = dict(shape=what, **{
            k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "max_abs_err")})
        if lib_real is not None:
            entry["library_real_ms"] = cuda_ms(lib_real, reps=5, warmup=1)
            print(f"    beside it: torch.fft.rfft/irfft "
                  f"{entry['library_real_ms']:.3f} ms")
        shapes.setdefault(name, []).append(entry)

    # --- the FFT kernels on ST's inverse rows, both directions ---------
    st = fe._objs["st"]
    n = st.fft_length
    re, im = st_rows(st, x)
    z = torch.complex(re, im)
    nrows = re.numel() // n
    shape_row("fft_pow2", fft_fwd, fft_fwd_ref,
              lambda: torch.fft.fft(z, dim=-1), (re, im), 8,
              16 * re.numel(), nrows, n,
              f"forward {nrows}x{n} complex, ST's inverse rows")
    shape_row("fft_inv", fft_inv, fft_inv_ref,
              lambda: torch.fft.ifft(z, dim=-1), (re, im), 8,
              16 * re.numel(), nrows, n,
              f"{nrows}x{n} complex, ST's inverse rows")
    del re, im, z
    # --- the forward on Deep's frames (real) ---------------------------
    rows = deep_rows(d["deep1"], x5)
    nrows = rows.numel() // n
    shape_row("fft_pow2", fft_fwd, fft_fwd_ref,
              lambda: torch.fft.fft(rows, dim=-1), (rows,), 1,
              12 * rows.numel(), nrows, n,
              f"forward {nrows}x{n} real, Deep's frames")
    del rows
    # --- the DSP calls' rows: Hilbert's inverse at 4096, xcorr's
    # transforms at 8192 (one clip of 4096 zero-padded) -----------------
    F = torch.fft.fft(xs, dim=-1)
    F[..., 1:C3_N // 2] *= 2
    F[..., C3_N // 2 + 1:] = 0
    hr, hi = F.real.contiguous(), F.imag.contiguous()
    shape_row("fft_inv", fft_inv, fft_inv_ref,
              lambda: torch.fft.ifft(F, dim=-1), (hr, hi), 250,
              16 * hr.numel(), C3_CLIPS, C3_N,
              f"{C3_CLIPS}x{C3_N} complex, Hilbert's inverse")
    # xcorr's forwards read the clip's n live samples of its 2n-point row
    # and write the half spectrum; its inverse takes the half product
    n2 = 2 * C3_N
    h2 = C3_N + 1
    xp = torch.nn.functional.pad(xs, (0, C3_N))
    shape_row("fft_pow2", lambda v: fft_fwd(v, bins=h2, n=n2),
              lambda v: fft_fwd_ref(v, None, h2, n2),
              lambda: torch.fft.fft(xp, dim=-1), (xs,), 250,
              4 * xs.numel() + 8 * C3_CLIPS * h2, C3_CLIPS, n2,
              f"forward {C3_CLIPS}x{n2} real, {C3_N} live, bins={h2}, "
              "xcorr's (real-row route)",
              lib_real=lambda: torch.fft.rfft(xs, n=n2, dim=-1))
    A = torch.fft.rfft(xs, n=n2, dim=-1)
    Ph = A * torch.fft.rfft(ys, n=n2, dim=-1).conj()
    pr, pi = Ph.real.contiguous(), Ph.imag.contiguous()
    P = torch.cat([Ph, Ph[..., 1:C3_N].flip(-1).conj()], dim=-1)
    shape_row("fft_inv", *half_inv(n2), lambda: torch.fft.ifft(P, dim=-1).real,
              (pr, pi), 250, 8 * pr.numel() + 4 * C3_CLIPS * n2, C3_CLIPS,
              n2, f"{C3_CLIPS}x{n2} to real output from the half product "
              f"({h2} bins), xcorr's (real-row route)",
              lib_real=lambda: torch.fft.irfft(Ph, n=n2, dim=-1))
    hr = hi = None
    del F, hr, hi, xp, P, Ph, pr, pi

    # --- the users' calls: audio-hours per second ------------------------
    h5 = x5.numel() / SR / 3600.0
    h3 = xs.numel() / SR / 3600.0
    D = d["D"]
    for name, fn, h in (
            ("ST.st", lambda: st.st(x), hours),
            ("DeepSpectrogram order 1", lambda: d["deep1"].spectrogram(x5),
             h5),
            ("DeepSpectrogram order 4", lambda: d["deep4"].spectrogram(x5),
             h5),
            ("DeepChromaSpectrogram", lambda: d["chroma"].spectrogram(x5),
             h5),
            ("Cepstrogram", lambda: d["cep"].cepstrogram(x5), h5),
            ("hilbert", lambda: hilbert(xs), h3),
            ("xcorr", lambda: xcorr(xs, ys), h3),
            ("czt", lambda: czt(xs, 0.1, 0.3), h3),
            ("phase_vocoder", lambda: phase_vocoder(D, PV_SLIDE, PV_RATE),
             h5)):
        ms = cuda_ms(fn, reps=5, warmup=1)
        print(f"  {name}: {ms:.3f} ms, {h / (ms / 1e3):.3f} audio-hours/s")
    return shapes


def merge_slice8(rows, launches, shapes):
    """The kernels line's rows gain the slice-8 paths' launches and the
    FFT rows their readings at slice 8's shapes (under ``shapes``)."""
    for row in rows:
        key = {"fft_pow2": "fft_pow2", "fft_inv": "fft_inv",
               "cwt_ifft_bank": "cwt_ifft_bank"}.get(row["name"])
        if key is not None:
            row["launches"] += launches.get(key, 0)
        if row["name"] in shapes:
            row.setdefault("shapes", []).extend(shapes[row["name"]])
    return rows


# --- slice 9: the pitch engines, HarmonicRatio, TuneTrack,
# TimeStretch/PitchShift and the classic family ----------------------------

def s9_plans(device):
    """The slice's plans at their reference defaults (radix2_exp 12, the
    engines' own slides: 1024 for every one here), on ``device``."""
    d = {"device": device}
    return dict(
        ncf=PitchNCF(samplate=SR, **d), cep=PitchCEP(samplate=SR, **d),
        hps=PitchHPS(samplate=SR, **d), lhs=PitchLHS(samplate=SR, **d),
        pef=PitchPEF(samplate=SR, **d), hr=HarmonicRatio(samplate=SR, **d),
        stft=PitchSTFT(samplate=SR, **d), ffp=PitchFFP(samplate=SR, **d),
        harm=Harmonic(samplate=SR, **d), tune=TuneTrack(samplate=SR, **d),
        hpssnmf=HPSSNMF(k=S9_NMF_K, **d), ts=TimeStretch(**d),
        ps=PitchShift(**d))


def s9_rows(p, x):
    """The rows the batched engines hand the FFT kernels, rebuilt as they
    build them: NCF's and HarmonicRatio's autocorrelation operands at 8192,
    HPS's frames (4,096 live samples of 32768 rows, and the bins it keeps),
    PEF's frames (4,096 of 8192), its log-grid power (8,192 live samples at
    pad_num of 32768) and the half spectrum of its product; and the whole
    product spectrum of PEF's padded rows (the complex rows at 32768, on no
    main path)."""
    pef = p["pef"]
    X = pef.xcorr_fft_length
    power = pef._log_power(x)
    pr, pi = pef._xcorr_spectrum(power)
    fr, fi = pef._xcorr_spectrum(pef._xcorr_rows(x))
    hr = p["hr"]
    hr_frames = x.unfold(-1, hr.window_length, hr.slide_length) * hr._window_t
    return dict(
        ncf=autocorr_operands(p["ncf"]._frames(x), 2 * p["ncf"].fft_length),
        hr=autocorr_operands(hr_frames, hr.fft_length),
        ncf_frames=p["ncf"]._frames(x).contiguous(),
        hr_frames=hr_frames.contiguous(),
        ncf_lags=p["ncf"].max_index + 1, hr_lags=hr.max_length + 1,
        hps=p["hps"]._frames(x).contiguous(),
        hps_n=p["hps"].interp_fft_length,
        hps_bins=min(int(p["hps"]._hidx.max()) + 1, X),
        pef8=pef._frames(x).contiguous(), pef8_n=2 * pef.fft_length,
        pef_buf=power.contiguous(), pef_lo=pef._pad_num,
        pef_half=(pr, pi), pef_prod=(fr, fi), X=X)


def real_inv(yr, yi):
    """``fft_inv`` with real output (the real-row route from 8192 on), the
    real part alone."""
    return fft_inv(yr, yi, out_imag=False)[0]


def real_inv_ref(yr, yi):
    return fft_inv_ref(yr, yi, out_imag=False)[0]


def half_inv(n):
    """``fft_inv`` of half spectra of n and its plain version."""
    return (lambda a, b: fft_inv(a, b, n=n)[0],
            lambda a, b: fft_inv_ref(a, b, n=n)[0])


def live_fwd(n, bins, lo=0):
    """``fft_fwd`` of live spans (rows at lo in n zeros) and its plain
    version."""
    return (lambda v: fft_fwd(v, bins=bins, n=n, lo=lo),
            lambda v: fft_fwd_ref(v, None, bins, n, lo))


def phase2_slice9_kernels(gen):
    phase("phase 2f: the FFT kernels at slice 9's shapes against their "
          "plain versions, over the whole batch (config 5's 8 x 30 s), and "
          "the users' calls on the real-row route with a live span")
    p = s9_plans("cuda")
    x = mir_signal(MIR_SMALL, MIR_SECONDS * SR, gen)
    r = s9_rows(p, x)
    X = r["X"]
    rows = r["hps"].numel() // r["hps"].shape[-1]
    errs = {}
    what = f"{rows} rows"
    errs["acf_ncf"] = whole_batch(
        f"fft_autocorr 8192, NCF's {what}", fft_autocorr, fft_autocorr_ref,
        r["ncf"], 1, FFT_TOL)
    errs["acf_hr"] = whole_batch(
        f"fft_autocorr 8192, HarmonicRatio's {what}", fft_autocorr,
        fft_autocorr_ref, r["hr"], 1, FFT_TOL)
    K = r["hps_bins"]
    errs["hps"] = whole_batch(
        f"fft_pow2 real {r['hps_n']} bins={K}, 4096 live (real-row route), "
        f"HPS's {what}", *live_fwd(r["hps_n"], K), (r["hps"],), 1, FFT_TOL)
    errs["pef_buf"] = whole_batch(
        f"fft_pow2 real {X} bins={X // 2 + 1}, {r['pef_buf'].shape[-1]} live "
        f"at {r['pef_lo']} (real-row route), PEF's cross-correlation {what}",
        *live_fwd(X, X // 2 + 1, r["pef_lo"]), (r["pef_buf"],), 1, FFT_TOL)
    errs["pef_fwd_c"] = whole_batch(
        f"fft_pow2 complex {X} (cluster route; no main path), PEF's whole "
        f"product {what}", fft_fwd, fft_fwd_ref, r["pef_prod"], 1, FFT_TOL)
    errs["pef_inv_c"] = whole_batch(
        f"fft_inv {X} complex output (cluster route; no main path), PEF's "
        f"whole "
        f"product {what}", fft_inv, fft_inv_ref, r["pef_prod"], 1, FFT_TOL)
    errs["pef_inv_whole"] = whole_batch(
        f"fft_inv {X} real output of the whole product (real-row route; no "
        f"main path since the half spectrum), {what}", real_inv,
        real_inv_ref, r["pef_prod"], 1, FFT_TOL)
    errs["pef_inv"] = whole_batch(
        f"fft_inv {X} from the half product (real-row route), PEF's {what}",
        *half_inv(X), r["pef_half"], 1, FFT_TOL)
    n8 = r["pef8_n"]
    b8 = n8 // 2 + 1
    errs["pef8"] = whole_batch(
        f"fft_pow2 real {n8} bins={b8} (rfft), 4096 live, PEF's frames, "
        f"{what}", *live_fwd(n8, b8), (r["pef8"],), 1, FFT_TOL)
    del r
    # the users' calls: HPS, LHS, PEF and xcorr launch the real-row route
    # with a live span (PEF and xcorr its half-spectrum inverse too) and
    # never a complex-row route
    own = torch.Generator(device="cuda")
    own.manual_seed(13)
    xs = randn((C3_CLIPS, C3_N), own, 0.2)
    for label, fn, need in (
            ("PitchHPS.pitch", lambda: p["hps"].pitch(x), ()),
            ("PitchLHS.pitch", lambda: p["lhs"].pitch(x), ()),
            ("PitchPEF.pitch", lambda: p["pef"].pitch(x),
             ("fft_inv half spectrum",)),
            (f"xcorr, {C3_CLIPS} x {C3_N}", lambda: xcorr(xs, xs.roll(1, 0)),
             ("fft_inv half spectrum",))):
        zero_counts()
        fn()
        torch.cuda.synchronize()
        c = read_counts()
        require_launched(label, {k: c[k] for k in (
            "fft_pow2 real-row route", "fft_pow2 live span", *need)})
        if any(c[f"{d} {w} route"] for d in ("fft_pow2", "fft_inv")
               for w in ("row", "cluster")):
            raise AssertionError(f"{label} took a complex-row route: {c}")
    return errs


def share_gate(label, got, ref, tol, share=S9_SHARE):
    """At most ``share`` of the frames may differ by more than ``tol``;
    prints the count and the largest difference."""
    got = torch.as_tensor(np.asarray(got.cpu() if isinstance(
        got, torch.Tensor) else got)).double().reshape(-1)
    ref = torch.as_tensor(np.asarray(ref.cpu() if isinstance(
        ref, torch.Tensor) else ref)).double().reshape(-1)
    diff = (got - ref).abs()
    n_off = int((diff > tol).sum())
    print(f"  gate {label}: {n_off} of {diff.numel()} frames differ by more "
          f"than {tol:g} (limit {share:.0%}); largest difference "
          f"{float(diff.max()):.4g}", flush=True)
    if n_off > share * diff.numel():
        raise AssertionError(f"{label}: {n_off} of {diff.numel()} frames")


def pitch_index(name, plan, fre):
    """The bin or lag index behind each frame's pitch (the argmax the
    engine took), so that "one bin" is one step of its own grid."""
    fre = torch.as_tensor(fre).double().cpu()
    if name == "ncf":
        return torch.round(SR / fre)
    if name == "cep":
        return torch.round(SR / fre) - 1
    if name in ("hps", "lhs"):
        return torch.round(fre * plan.interp_fft_length / SR) - 1
    grid = torch.from_numpy(plan._log_fre.astype(np.float32)).double()
    return torch.searchsorted(grid, fre).double()


def phase3_slice9_paths(gen):
    phase("phase 3f: slice 9 at full width (the pitch engines, "
          "HarmonicRatio, TuneTrack, TimeStretch/PitchShift, the classic "
          "family)")
    launches = {}
    p, pc = s9_plans("cuda"), s9_plans("cpu")
    x = mir_signal(MIR_SMALL, MIR_SECONDS * SR, gen)
    ends = [0, MIR_SMALL - 1]
    xc = x[ends].cpu()
    rows = MIR_SMALL * p["ncf"].cal_time_length(x.shape[-1])
    row_gb = rows * 4 / 1e9            # one fp32 value a frame
    real_f, real_i = "fft_pow2 real-row route", "fft_inv real-row route"
    complex_routes = ("fft_pow2 cluster route", "fft_inv cluster route",
                      "fft_pow2 row route", "fft_inv row route")
    # --- the batched engines and HarmonicRatio on 8 x 30 s -------------
    # reckoned: NCF its frames (4096 a row, made contiguous), the lags the
    # frames entry writes and their scaled copy (2 x 1001); HPS/LHS the frames (4096; the transform reads
    # them as they are), the kept bins' parts, their complex copy and
    # magnitude (5 x 10001) and the gather; PEF the spectrum's kept bins at
    # 8192 and their power (3 x 4097), the log-grid power (8192), the half
    # spectrum's and the product's parts (4 x 16385) and the inverse
    # (32768); CEP torch.fft's complex tiles (6 x 8192).  HPS, LHS and PEF
    # must take the real-row route with a live span (PEF's inverse from the
    # half spectrum) and never a complex-row route; NCF and HarmonicRatio
    # the frames entry of the autocorrelation, never the general entry
    live, half = "fft_pow2 live span", "fft_inv half spectrum"
    batched = (("ncf", ("fft_autocorr_frames",), ("fft_autocorr",),
                4096 + 2 * 1001),
               ("cep", (), ("fft_pow2", "fft_inv", "fft_autocorr"), 6 * 8192),
               ("hps", ("fft_pow2", real_f, live), complex_routes,
                4096 + 6 * 10001),
               ("lhs", ("fft_pow2", real_f, live), complex_routes,
                4096 + 6 * 10001),
               ("pef", ("fft_pow2", real_f, live, "fft_inv", real_i, half),
                complex_routes, 8192 + 4 * 16385 + 32768 + 3 * 4097))
    out = {}
    for name, req, forbid, per_row in batched:
        plan = p[name]
        fre, _ = count_call(f"{type(plan).__name__}.pitch, {MIR_SMALL} x "
                       f"{MIR_SECONDS} s", lambda: plan.pitch(x), req,
                       per_row * row_gb, launches, forbid)
        if tuple(fre.shape) != (MIR_SMALL, rows // MIR_SMALL) or not bool(
                torch.isfinite(fre).all()):
            raise AssertionError(f"3f {name}: shape {tuple(fre.shape)} or "
                                 "non-finite values")
        ref = pc[name].pitch(xc)
        share_gate(f"3f {type(plan).__name__} bin or lag (first and last "
                   "clip) vs CPU, more than one step",
                   pitch_index(name, plan, fre[ends].cpu()),
                   pitch_index(name, plan, ref), 1.0)
        out[name] = fre
    hr, _ = count_call(f"HarmonicRatio.harmonic_ratio, {MIR_SMALL} x "
                  f"{MIR_SECONDS} s", lambda: p["hr"].harmonic_ratio(x),
                  ("fft_autocorr_frames",), 4 * 4096 * row_gb, launches,
                  ("fft_autocorr",))
    share_gate("3f HarmonicRatio (first and last clip) vs CPU",
               hr[ends], pc["hr"].harmonic_ratio(xc), S9_HR_TOL)
    # --- TimeStretch and PitchShift on 8 x 30 s -------------------------
    spec_gb = rows * 2049 * 8 / 1e9
    for label, fn, fn_c in (
            [(f"TimeStretch rate {r}", lambda r=r: p["ts"].time_stretch(x, r),
              lambda r=r: pc["ts"].time_stretch(xc, r)) for r in S9_RATES]
            + [(f"PitchShift {s:+d} semitones",
                lambda s=s: p["ps"].pitch_shift(x, s, SR),
                lambda s=s: pc["ps"].pitch_shift(xc, s, SR))
               for s in S9_SHIFTS]):
        y, _ = count_call(f"{label}, {MIR_SMALL} x {MIR_SECONDS} s", fn,
                     ("fft_pow2", "fft_inv"), 12 * spec_gb, launches)
        if not bool(torch.isfinite(y).all()):
            raise AssertionError(f"3f {label}: non-finite values")
        check(f"gate 3f {label} (first and last clip) vs CPU",
              gate_err(y[ends], fn_c()), S9_TS_TOL)
        del y
    # --- the single-signal engines on one 30 s clip ---------------------
    x1, x1c = x[0], xc[0]
    n1 = x1.numel()
    bin_hz = SR / p["stft"].fft_length
    one = f"one {MIR_SECONDS} s clip"
    (fre, db), _ = count_call(f"PitchSTFT.pitch, {one}",
                       lambda: p["stft"].pitch(x1), ("fft_pow2",), 0.2,
                       launches)
    fre_c, db_c = pc["stft"].pitch(x1c)
    share_gate("3f PitchSTFT fre vs CPU, more than one bin", fre, fre_c,
               bin_hz)
    (fre, db), _ = count_call(f"PitchFFP.pitch, {one}",
                       lambda: p["ffp"].pitch(x1), ("fft_pow2",), 0.2,
                       launches)
    fre_c, db_c = pc["ffp"].pitch(x1c)
    share_gate("3f PitchFFP fre vs CPU, more than one bin", fre, fre_c,
               bin_hz)
    cnt, _ = count_call(f"Harmonic.exec -> count_range(80, 4000), {one}",
                   lambda: p["harm"].exec(x1).count_range(80, 4000),
                   ("fft_pow2",), 0.2, launches)
    share_gate("3f Harmonic counts vs CPU", cnt,
               pc["harm"].exec(x1c).count_range(80, 4000), 0.0)
    p["tune"].clear()
    tf, _ = count_call(f"TuneTrack.tune, {one}",
                  lambda: p["tune"].tune(x1),
                  ("fft_pow2", "fft_autocorr_frames", "fft_autocorr_yin"),
                  0.5, launches, ("fft_autocorr",))
    pc["tune"].clear()
    tf_c = pc["tune"].tune(x1c)
    share_gate("3f TuneTrack fre vs CPU, more than one bin", tf, tf_c,
               bin_hz)
    print(f"  TuneTrack: {int((tf > 0).sum())} of {tf.size} frames tracked "
          f"(CPU {int((tf_c > 0).sum())})")
    # HPSSNMF: the masks sum to 1, so h + p is the input inside its
    # edges; NMF on the card reaches a different rounding of the
    # factors, so the split is held by its energy share against the CPU
    # and the factors' reconstruction below
    (h, pp), _ = count_call(f"HPSSNMF.hpss, {one}",
                     lambda: p["hpssnmf"].hpss(x1), ("fft_pow2", "fft_inv"),
                     24 * 2049 * (rows // MIR_SMALL) * 4 / 1e9, launches)
    h_c, p_c = pc["hpssnmf"].hpss(x1c)
    N = p["hpssnmf"].fft_length
    peak = float(x1.abs().max())
    check("gate 3f HPSSNMF h + p vs the input inside the edges",
          float((h + pp - x1[:h.numel()])[N:-N].abs().max()) / peak,
          S9_REC_TOL)
    share = float((h * h).sum() / ((h * h).sum() + (pp * pp).sum()))
    share_c = float((h_c * h_c).sum() / ((h_c * h_c).sum()
                                         + (p_c * p_c).sum()))
    print(f"  HPSSNMF harmonic energy share {share:.5f} (CPU {share_c:.5f});"
          f" h, p vs CPU {gate_err(h, h_c):.3e}, {gate_err(pp, p_c):.3e} "
          "of the peak (printed)")
    if not abs(share - share_c) <= S9_SPLIT_TOL:
        raise AssertionError(f"HPSSNMF energy share {share} vs {share_c}")
    # --- NMF on HPSSNMF's magnitude, HMM, viterbi -----------------------
    nmf_plan = p["hpssnmf"]
    V = stft_mag(nmf_plan, x1)
    (W, H), _ = count_call(f"nmf(k={S9_NMF_K}) on HPSSNMF's magnitude "
                    f"{tuple(V.shape)}",
                    lambda: nmf(V, S9_NMF_K, max_iter=nmf_plan.max_iter,
                                device="cuda"), (), 12 * V.numel() * 4 / 1e9,
                    launches)
    Wc, Hc = nmf(V.cpu(), S9_NMF_K, max_iter=nmf_plan.max_iter, device="cpu")
    rec = float((V - W @ H).abs().mean())
    rec_c = float((V.cpu() - Wc @ Hc).abs().mean())
    print(f"  NMF reconstruction mean |V - WH|: card {rec:.6e}, CPU "
          f"{rec_c:.6e} (limit 1.05 x the CPU's); factors vs CPU: W "
          f"{gate_err(W, Wc):.3e}, H {gate_err(H, Hc):.3e} of the peak")
    if not rec <= 1.05 * rec_c:
        raise AssertionError("NMF reconstruction on the card > 1.05 x CPU")
    hmm = HMM(S9_HMM_S, S9_HMM_N, seed=0, device="cuda")
    hmm_c = HMM(S9_HMM_S, S9_HMM_N, seed=0, device="cpu")
    o_train, _ = hmm.generate(S9_HMM_T, seed=1)
    count_call(f"HMM({S9_HMM_S}, {S9_HMM_N}).train, {S9_HMM_T} steps",
             lambda: hmm.train(o_train, max_iter=S9_HMM_ITERS), (), 0.01,
             launches)
    hmm_c.train(o_train, max_iter=S9_HMM_ITERS)
    err = max(float(np.abs(a - b).max()) for a, b in (
        (hmm.pi, hmm_c.pi), (hmm.A, hmm_c.A), (hmm.B, hmm_c.B)))
    print(f"  HMM trained parameters vs CPU: max |diff| {err:.3e} "
          "(limit 1e-4)")
    if not err <= 1e-4:
        raise AssertionError("HMM parameters differ from the CPU's")
    s_d, p_d = hmm.decode(o_train)
    s_c, p_dc = hmm_c.decode(o_train)
    if not np.array_equal(s_d, s_c) or not abs(p_d - p_dc) <= 1e-4 * abs(
            p_dc):
        raise AssertionError("HMM.decode differs from the CPU's")
    print(f"  HMM.decode ({S9_HMM_T} steps): states equal, probability "
          f"{p_d:.6e} (CPU {p_dc:.6e})")
    o_long, _ = hmm.generate(rows, seed=2)
    (s_v, p_v, m_v), _ = count_call(
        f"viterbi(is_log=True), T = {rows}, {S9_HMM_S} states",
        lambda: viterbi(hmm.pi, hmm.A, hmm.B, o_long, is_log=True,
                        device="cuda"), (), 0.01, launches)
    s_vc, p_vc, m_vc = viterbi(hmm.pi, hmm.A, hmm.B, o_long, is_log=True,
                               device="cpu")
    share_gate("3f viterbi states vs CPU", s_v, s_vc, 0.0)
    check("gate 3f viterbi log-probabilities vs CPU (relative)",
          float(((m_v.cpu() - m_vc).abs() / m_vc.abs()).max()), 1e-5)
    print(f"  launches on the slice-9 paths: "
          f"{ {k: v for k, v in launches.items() if v} }")
    return dict(p=p, x=x, x1=x1, V=V, hmm=hmm, o_train=o_train,
                o_long=o_long, launches=launches)


def stft_mag(plan, x1):
    """HPSSNMF's magnitude (m, T) of one clip, as its call builds it."""
    frames = x1.unfold(-1, plan.fft_length, plan.slide_length)
    return torch.fft.rfft(frames * plan._window_t, dim=-1).abs().T.contiguous()


def phase4_slice9_timing(d, errs):
    phase("phase 4f: slice 9 timing (CUDA events, median)")
    p, x, x1 = d["p"], d["x"], d["x1"]
    hours = x.numel() / SR / 3600.0
    shapes = {}
    call_ms = {}
    for name, fn in (("PitchNCF", lambda: p["ncf"].pitch(x)),
                     ("PitchCEP", lambda: p["cep"].pitch(x)),
                     ("PitchHPS", lambda: p["hps"].pitch(x)),
                     ("PitchLHS", lambda: p["lhs"].pitch(x)),
                     ("PitchPEF", lambda: p["pef"].pitch(x)),
                     ("HarmonicRatio", lambda: p["hr"].harmonic_ratio(x)),
                     *[(f"TimeStretch rate {r}",
                        lambda r=r: p["ts"].time_stretch(x, r))
                       for r in S9_RATES],
                     *[(f"PitchShift {s:+d}",
                        lambda s=s: p["ps"].pitch_shift(x, s, SR))
                       for s in S9_SHIFTS]):
        ms = cuda_ms(fn, reps=5, warmup=1)
        call_ms[name] = ms
        print(f"  {name}, {MIR_SMALL} x {MIR_SECONDS} s: {ms:.3f} ms, "
              f"{hours / (ms / 1e3):.3f} audio-hours/s")

    def host_ms(fn, reps=3):
        """Median wall ms of ``fn()`` (a call that ends on the host)."""
        fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times)[len(times) // 2]
    h1 = x1.numel() / SR / 3600.0
    for name, fn in (("PitchSTFT.pitch", lambda: p["stft"].pitch(x1)),
                     ("PitchFFP.pitch", lambda: p["ffp"].pitch(x1)),
                     ("Harmonic.exec", lambda: p["harm"].exec(x1)),
                     ("TuneTrack.tune", lambda: (p["tune"].clear(),
                                                 p["tune"].tune(x1))),
                     ("HPSSNMF.hpss", lambda: p["hpssnmf"].hpss(x1))):
        ms = host_ms(fn)
        call_ms[name] = ms
        print(f"  {name}, one {MIR_SECONDS} s clip: {ms:.3f} ms (host clock), "
              f"{h1 / (ms / 1e3):.4f} audio-hours/s")
    V = d["V"]
    nmf_key = f"nmf(k={S9_NMF_K}) on {tuple(V.shape)}"
    for name, fn in (
            (nmf_key,
             lambda: nmf(V, S9_NMF_K, max_iter=p["hpssnmf"].max_iter,
                         device="cuda")),
            (f"HMM.train, {S9_HMM_T} steps, {S9_HMM_ITERS} iterations",
             lambda: HMM(S9_HMM_S, S9_HMM_N, seed=0, device="cuda").train(
                 d["o_train"], max_iter=S9_HMM_ITERS)),
            (f"viterbi(is_log=True), T = {len(d['o_long'])}",
             lambda: viterbi(d["hmm"].pi, d["hmm"].A, d["hmm"].B,
                             d["o_long"], is_log=True, device="cuda"))):
        ms = host_ms(fn)
        call_ms[name] = ms
        print(f"  {name}: {ms:.3f} ms (host clock)")
    steps = len(d["o_long"])
    print(f"  viterbi: {call_ms[name] / steps * 1e3:.2f} us a step "
          "(one step a launch chain: the recursion's launch cost)")
    # NMF's iterations (its update counted through the module) and the
    # cost of its host check (two norms stacked and fetched) an iteration
    nmod = importlib.import_module("audioflux_torch.classic.nmf")
    update, its = nmod._update, [0]

    def counting(*args):
        its[0] += 1
        return update(*args)
    nmod._update = counting
    try:
        nmf(V, S9_NMF_K, max_iter=p["hpssnmf"].max_iter, device="cuda")
    finally:
        nmod._update = update
    a = torch.ones((), device="cuda")
    check_us = host_ms(lambda: [torch.stack([torch.linalg.norm(a),
                                             torch.linalg.norm(a)]).tolist()
                                for _ in range(100)]) * 10.0
    print(f"  nmf: {its[0]} iterations, {call_ms[nmf_key] / its[0]:.3f} ms "
          f"an iteration; the host check alone {check_us:.1f} us an "
          "iteration (host clock, 100 in a row)")

    r = s9_rows(p, x)
    X = r["X"]
    nrows = r["hps"].numel() // r["hps"].shape[-1]

    def shape_row(name, fn, ref, lib, tensors, n_bytes, n_ops, what, err,
                  lib_real=None, lib_tensors=None):
        """One entry of a kernel's ``shapes`` at this slice's rows;
        ``lib_real`` calls ``torch.fft.rfft`` or ``irfft`` where they give
        the same values (timed beside the library call, as
        ``library_real_ms``); ``lib_tensors``: the library call's inputs
        where they are not the kernel's (whole rows for live spans)."""
        k_ms = cuda_ms(lambda: fn(*tensors), reps=10)
        p_ms = cuda_ms(chunked(ref, tensors, 1), reps=3, warmup=1)
        l_ms = cuda_ms(chunked(lib, lib_tensors or tensors, 1), reps=3,
                       warmup=1)
        row = kernel_row(name, "fft_pow2", "audioflux_tpu/ops/pallas_fft.py:"
                         + {"fft_pow2": "346", "fft_inv": "360",
                            "fft_autocorr": "267"}[name], 0, err, k_ms, p_ms,
                         l_ms, n_bytes, n_ops, what)
        entry = dict(shape=what, **{
            k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "max_abs_err")})
        if lib_real is not None:
            entry["library_real_ms"] = cuda_ms(lib_real, reps=3, warmup=1)
            print(f"    beside it: torch.fft.rfft/irfft "
                  f"{entry['library_real_ms']:.3f} ms")
        shapes.setdefault(name, []).append(entry)
        return entry

    def acf_lib(a, b):
        s = torch.fft.fft(torch.complex(a, b), dim=-1)
        return torch.fft.ifft(s * s, dim=-1)

    def fwd_lib(a, b=None):
        return torch.fft.fft(a if b is None else torch.complex(a, b), dim=-1)

    def inv_lib(a, b):
        return torch.fft.ifft(torch.complex(a, b), dim=-1)

    def padded(rows_, n_, lo_):
        """The live rows placed at lo_ in rows of n_ zeros, made once (the
        library calls take whole rows)."""
        return torch.nn.functional.pad(
            rows_, (lo_, n_ - lo_ - rows_.shape[-1])).contiguous()

    def rfft_lib(rows_):
        return chunked(lambda a: torch.fft.rfft(a, dim=-1), (rows_,), 1)
    n8 = r["pef8_n"]
    acf_ops = nrows * (10.0 * n8 * math.log2(n8) + 6.0 * n8)
    shape_row("fft_autocorr", fft_autocorr, fft_autocorr_ref, acf_lib,
              r["ncf"], 12 * r["ncf"][0].numel(), acf_ops,
              f"{nrows}x{n8} rows (xr, xi), NCF's operands, general entry "
              "(registers)", errs["acf_ncf"])
    shape_row("fft_autocorr", fft_autocorr, fft_autocorr_ref, acf_lib,
              r["hr"], 12 * r["hr"][0].numel(), acf_ops,
              f"{nrows}x{n8} rows (xr, xi), HarmonicRatio's operands, "
              "general entry (registers)", errs["acf_hr"])
    # the frames entry (NCF's and HarmonicRatio's call): the frames in,
    # the lags kept out; the library yardstick is irfft(|rfft|^2), sliced
    frames_entry = {}
    for who in ("ncf", "hr"):
        f_, lags_ = r[f"{who}_frames"], r[f"{who}_lags"]
        e = shape_row(
            "fft_autocorr",
            lambda f, lags_=lags_: fft_autocorr_frames(f, n8, lags_),
            lambda f, lags_=lags_: fft_autocorr_frames_ref(f, n8, lags_),
            lambda f, lags_=lags_: torch.fft.irfft(
                torch.fft.rfft(f, n=n8).abs().square(), n=n8)[..., :lags_],
            (f_,), 4 * f_.numel() + 4 * nrows * lags_, acf_ops,
            f"frames entry, {nrows}x{f_.shape[-1]} frames -> {lags_} lags "
            f"of {n8}, {'NCF' if who == 'ncf' else 'HarmonicRatio'}'s",
            errs["frames"])
        frames_entry[who] = e
    k_ncf = frames_entry["ncf"]["ms"]
    # the general entry at 16384 (registers) and 32768 (the clusters), and
    # the complex rows at 8192 and 16384 (the row route, row_reg_kernel),
    # on 7,472 random rows, laid out as the engines' (clips, frames, n) so
    # that the plain and library calls go a clip at a time
    own = torch.Generator(device="cuda")
    own.manual_seed(141)
    lead = (MIR_SMALL, nrows // MIR_SMALL)
    for n_ in (16384, 32768):
        xr_ = randn(lead + (n_,), own)
        xi_ = randn(lead + (n_,), own)
        ops_ = nrows * (10.0 * n_ * math.log2(n_) + 6.0 * n_)
        shape_row("fft_autocorr", fft_autocorr, fft_autocorr_ref, acf_lib,
                  (xr_, xi_), 12 * xr_.numel(), ops_,
                  f"{nrows}x{n_} random rows (xr, xi), general entry "
                  f"({'clusters' if n_ == 32768 else 'registers'})",
                  errs[f"acf {n_}"])
        del xr_, xi_
    for n_ in (8192, 16384):
        xr_ = randn(lead + (n_,), own)
        xi_ = randn(lead + (n_,), own)
        ops_ = nrows * 5.0 * n_ * math.log2(n_)
        e_f = pair_err(fft_fwd(xr_, xi_), fft_fwd_ref(xr_, xi_))[0]
        e = shape_row("fft_pow2", fft_fwd, fft_fwd_ref, fwd_lib, (xr_, xi_),
                      16 * xr_.numel(), ops_,
                      f"forward {nrows}x{n_} complex (row route)", e_f)
        # the cuts: the load and the store alone (stages 1), and the
        # spectrum with its stores through the transpose buffer (stages 2)
        # against the stores from registers (the kernel, stages 3)
        cut = [cuda_ms(lambda s=s_: cuda_fft._fwd(xr_, xi_, n_, stages=s),
                       reps=10) for s_ in (1, 2, 3)]
        e["cuts_ms"] = {"load_store": cut[0], "transform": cut[2] - cut[0],
                        "stores_via_buffer": cut[1],
                        "stores_from_registers": cut[2]}
        print(f"  split (row route, forward, n={n_}): load + store "
              f"{cut[0]:.3f} ms, the {n_}-point transform "
              f"{cut[2] - cut[0]:.3f} (whole {cut[2]:.3f}); stores through "
              f"the buffer {cut[1]:.3f} against from registers {cut[2]:.3f}")
        e_i = pair_err(fft_inv(xr_, xi_), fft_inv_ref(xr_, xi_))[0]
        e = shape_row("fft_inv", fft_inv, fft_inv_ref, inv_lib, (xr_, xi_),
                      16 * xr_.numel(), ops_,
                      f"{nrows}x{n_} complex output (row route)", e_i)
        yr_, yi_ = torch.empty_like(xr_), torch.empty_like(xr_)

        def row_inv(stage):
            return lambda: cuda_fft._call(
                cuda_fft._lib().af_fft_pow2_inv, "fft_pow2 inverse", xr_, n_,
                xr_.data_ptr(), xi_.data_ptr(), yr_.data_ptr(),
                yi_.data_ptr(), extra=(n_, stage))
        cut = [cuda_ms(row_inv(s_), reps=10) for s_ in (1, 3)]
        e["cuts_ms"] = {"load_store": cut[0], "transform": cut[1] - cut[0]}
        print(f"  split (row route, inverse, n={n_}): load + store "
              f"{cut[0]:.3f} ms, the {n_}-point transform "
              f"{cut[1] - cut[0]:.3f} (whole {cut[1]:.3f})")
        del xr_, xi_, yr_, yi_
    # the real-row route: a real FFT of n points is about 2.5 n log2 n
    # operations; its bytes are the live samples in and the bins written
    fops = nrows * 5.0 * X * math.log2(X)
    rops = fops / 2
    # (label, rows, n, lo, bins, the error key): each as its engine calls it
    K = r["hps_bins"]
    calls = (("HPS's frames", r["hps"], r["hps_n"], 0, K, "hps"),
             ("PEF's log-grid power", r["pef_buf"], X, r["pef_lo"],
              X // 2 + 1, "pef_buf"),
             ("PEF's frames (rfft)", r["pef8"], n8, 0, n8 // 2 + 1, "pef8"))
    k_fwd = {}
    for label, rows_, n_, lo_, b_, key in calls:
        live_ = rows_.shape[-1]
        pad_ = padded(rows_, n_, lo_)
        e = shape_row(
            "fft_pow2", lambda v: fft_fwd(v, bins=b_, n=n_, lo=lo_),
            lambda v: fft_fwd_ref(v, None, b_, n_, lo_), fwd_lib, (rows_,),
            4 * rows_.numel() + 8 * nrows * b_,
            nrows * 2.5 * n_ * math.log2(n_),
            f"forward {nrows}x{n_} real, {live_} live at {lo_}, bins={b_}, "
            f"{label} (real-row route)", errs[key], lib_real=rfft_lib(pad_),
            lib_tensors=(pad_,))
        # the cuts (every cut stores as many values as the whole kernel):
        # load + store, + the n/2-point transform, + the split
        cut = [cuda_ms(lambda s=s_: cuda_fft._fwd(rows_, None, n_, b_,
                                                  stages=s, lo=lo_), reps=10)
               for s_ in (1, 2, 3)]
        e["cuts_ms"] = {"load_store": cut[0], "transform": cut[1] - cut[0],
                        "split": cut[2] - cut[1]}
        print(f"  split (real-row route, {label}, n={n_}, bins={b_}): load "
              f"+ store {cut[0]:.3f} ms, the {n_ // 2}-point transform "
              f"{cut[1] - cut[0]:.3f}, the split {cut[2] - cut[1]:.3f} (whole "
              f"{cut[2]:.3f})")
        k_fwd[key] = e["ms"]
        del pad_
    k_8, k_buf = k_fwd["pef8"], k_fwd["pef_buf"]
    shape_row("fft_pow2", fft_fwd, fft_fwd_ref, fwd_lib, r["pef_prod"],
              16 * r["pef_prod"][0].numel(), fops,
              f"forward {nrows}x{X} complex, PEF's whole product (cluster "
              "route; no main path)", errs["pef_fwd_c"])
    pr, pi = r["pef_half"]
    h = X // 2 + 1
    Ph = torch.complex(pr, pi)
    e = shape_row("fft_inv", *half_inv(X),
                  lambda a, b: torch.fft.irfft(torch.complex(a, b), n=X,
                                               dim=-1),
                  r["pef_half"], 8 * nrows * h + 4 * nrows * X, rops,
                  f"{nrows}x{X} to real output from the half product "
                  f"({h} bins), PEF's (real-row route)", errs["pef_inv"],
                  lib_real=chunked(lambda a: torch.fft.irfft(a, n=X, dim=-1),
                                   (Ph,), 1))
    k_inv = e["ms"]
    del Ph
    out = torch.empty(pr.shape[:-1] + (X,), device="cuda")

    def inv_cut(stage):
        return lambda: cuda_fft._call(
            cuda_fft._lib().af_fft_pow2_inv, "fft_pow2 inverse", pr, X,
            pr.data_ptr(), pi.data_ptr(), out.data_ptr(), None,
            extra=(h, stage))
    cut = [cuda_ms(inv_cut(s_), reps=10) for s_ in (1, 3)]
    e["cuts_ms"] = {"load_merge_store": cut[0], "transform": cut[1] - cut[0]}
    print(f"  split (real-row route, PEF's inverse, n={X}): load + merge + "
          f"store {cut[0]:.3f} ms, the {X // 2}-point transform "
          f"{cut[1] - cut[0]:.3f} (whole {cut[1]:.3f})")
    fr, fi = r["pef_prod"]
    shape_row("fft_inv", real_inv, real_inv_ref,
              lambda a, b: inv_lib(a, b).real, r["pef_prod"],
              12 * fr.numel(), rops,
              f"{nrows}x{X} to real output of the whole product (real-row "
              "route; no main path)", errs["pef_inv_whole"])
    shape_row("fft_inv", fft_inv, fft_inv_ref, inv_lib, r["pef_prod"],
              16 * fr.numel(), fops,
              f"{nrows}x{X} complex output, PEF's whole product (cluster "
              "route; no main path)", errs["pef_inv_c"])
    del out, r, pr, pi, fr, fi
    # --- the splits: kernels against PyTorch (and host) time ------------
    print(f"  split PitchNCF: fft_autocorr_frames {k_ncf:.3f} ms of "
          f"{call_ms['PitchNCF']:.3f} (PyTorch {call_ms['PitchNCF'] - k_ncf:.3f})")
    k_hr = frames_entry["hr"]["ms"]
    print(f"  split HarmonicRatio: fft_autocorr_frames {k_hr:.3f} ms of "
          f"{call_ms['HarmonicRatio']:.3f} (PyTorch "
          f"{call_ms['HarmonicRatio'] - k_hr:.3f})")
    k_pef = k_8 + k_buf + k_inv
    print(f"  split PitchPEF: kernels {k_pef:.3f} ms (forward 8192 {k_8:.3f}, "
          f"forward 32768 {k_buf:.3f}, inverse 32768 {k_inv:.3f}) of "
          f"{call_ms['PitchPEF']:.3f} (PyTorch "
          f"{call_ms['PitchPEF'] - k_pef:.3f})")
    ffp = p["ffp"]._chain
    fr1 = (x1.unfold(-1, ffp.fft_length, ffp.slide_length)
           * ffp._window_t).contiguous()
    k_1 = cuda_ms(lambda: fft_fwd(fr1), reps=10)
    dev_ms = host_ms(lambda: (lambda s: (s.real ** 2 + s.imag ** 2).cpu())(
        rfft(fr1, dim=-1)))
    print(f"  split PitchFFP: fft_pow2 {k_1:.3f} ms ({fr1.shape[0]} rows of "
          f"{ffp.fft_length}), device stage with the fetch {dev_ms:.3f} ms, "
          f"host chains {call_ms['PitchFFP.pitch'] - dev_ms:.3f} ms of "
          f"{call_ms['PitchFFP.pitch']:.3f}")
    hn = p["hpssnmf"]
    Vn = d["V"]
    nmf_ms = host_ms(lambda: nmf(Vn, hn.k, max_iter=hn.max_iter, tp=hn.tp,
                                 thresh=hn.thresh, device="cuda"))
    Z = torch.fft.fft(fr1, dim=-1)
    zr, zi = Z.real.contiguous(), Z.imag.contiguous()
    k_inv1 = cuda_ms(lambda: fft_inv(zr, zi), reps=10)
    # the NMF alone runs on the torch.fft magnitude, whose rounding may
    # move its stop by an iteration: its time is shown beside the call's,
    # not subtracted from it
    print(f"  split HPSSNMF.hpss ({call_ms['HPSSNMF.hpss']:.3f} ms): kernels "
          f"{k_1 + k_inv1:.3f} ms (forward {k_1:.3f}, inverse {k_inv1:.3f}); "
          f"the NMF loop alone {nmf_ms:.3f} ms (one host check an "
          "iteration)")
    shapes["frames_entry"] = frames_entry["ncf"]
    return shapes


def merge_slice9(rows, launches, shapes):
    """The kernels line's rows gain the slice-9 paths' launches and the
    FFT rows their readings at slice 9's shapes (under ``shapes``); the
    autocorrelation's entries gain their own launches, and its row counts
    both entries'."""
    for row in rows:
        name = row["name"]
        if name in ("fft_pow2", "fft_inv"):
            row["launches"] += launches.get(name, 0)
        if name == "fft_autocorr":
            fe = shapes["frames_entry"]
            row["entries"].append(dict(
                name="fft_autocorr", route="cuda", entry="fft_autocorr_frames",
                source=row["source"], replaces=row["replaces"], launches=0,
                **{k: fe[k] for k in ("max_abs_err", "ms", "plain_ms",
                                      "bound_ms", "bound_by",
                                      "library_ms")}, shape=fe["shape"]))
            for e in row["entries"]:
                e["launches"] += launches.get(e["entry"], 0)
            row["launches"] = sum(e["launches"] for e in row["entries"])
            row["measures"] += ("; launches: every entry's main-path "
                                "launches (the general entry's since "
                                "slice 9, the frames entry's, NCF's and "
                                "HarmonicRatio's, since slice 14)")
        if name in shapes and name != "frames_entry":
            row.setdefault("shapes", []).extend(shapes[name])
    return rows


# --- slice 10: the parallel family on a (data 2, time 4) mesh -------------
#
# Over eight distinct cards where the machine has them, else over its cards
# cycled (one H100: every shard on cuda:0).  a: the headline mel+MFCC fused
# per time shard on 16 recordings of 30 min (each time block 14,400,000
# samples, 28,125 slides), then plain, then the spectral statistics; b:
# config 5's STFT -> ISTFT on 8 x 10 min; c: config 4's wavelet width on 16
# noise clips (21 bands a shard) and ccwt on 2 x 2^20 samples; d: the
# full-signal twins at slice 8's extractor widths on 64 x 4096 (cst on 8 x
# 32768) and config 3's CQT on 1000 x 4096; e: config 5's HPSS and YIN
# through the batch map on 64 x 30 s; f: the headline chain in four
# pipeline stages on 64 clips of T = 1000; g: BatchRunner over 16 WAV files
# of 30 s; h: two processes (NCCL with a card each, else gloo on one card);
# i: the dry run.  The gates: equal, or within S10_EQ_TOL of the peak with
# the differing cells counted, against the unsharded call on the card.
S10_DATA, S10_TIME = 2, 4
S10_HEAD = (16, 1800)            # recordings, seconds
S10_STFT = (8, 600)
S10_WAV_CLIPS, S10_CCWT = 16, (2, 1 << 20)
S10_FE_CLIPS, S10_CQT_CLIPS, S10_CST = 64, 1000, (8, 1 << 15)
S10_MIR = (64, 30)
S10_PIPE = (64, 1000)            # clips, frames
S10_FILES = (16, 30)             # WAV files, seconds
S10_MP = (4, 64)                 # the two-process batch: recordings, seconds
S10_EQ_TOL = FP32_TOL
S10_COUNTERS = {"fused_mel_mfcc": (fused_mel_mfcc, "launches"),
                "fft_pow2": (fft_fwd, "launches"),
                "fft_pow2 real-row route": (fft_fwd, "real_launches"),
                "fft_inv": (fft_inv, "launches"),
                "fft_inv real-row route": (fft_inv, "real_launches"),
                "fft_autocorr": (fft_autocorr, "launches"),
                "fft_autocorr_yin": (fft_autocorr_yin, "launches"),
                "median_filter": (median_filter_last_axis, "launches"),
                "cwt_ifft_bank": (cwt_ifft_bank, "launches"),
                "synsq_bins": (synsq_bins, "launches"),
                "columnar_scatter": (columnar_scatter, "launches")}


def s10_counts(zero=False):
    if zero:
        for fn, attr in S10_COUNTERS.values():
            setattr(fn, attr, 0)
    return {k: getattr(fn, attr) for k, (fn, attr) in S10_COUNTERS.items()}


def s10_call(label, fn, per_shard, reckoned_gb, launches):
    """``fn()`` with every count set to 0 just before and read just after;
    each kernel in ``per_shard`` ({name: shards}) must have launched at
    least once a shard.  The peak device memory, and its part above what
    was held before the call beside the call's reckoning; the peak under
    MEM_LIMIT_GB.  Returns (fn's result, the counts)."""
    s10_counts(zero=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 1e9
    out = fn()
    torch.cuda.synchronize()
    counts = s10_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"  {label}: peak device memory {peak:.2f} GB, {peak - held:.2f} "
          f"GB above the {held:.2f} GB held before it (reckoned "
          f"{reckoned_gb:.2f} GB); launches "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    for k, shards in per_shard.items():
        if counts[k] < shards:
            raise AssertionError(f"{label}: {k} launched {counts[k]} times "
                                 f"for {shards} shards")
    if peak > MEM_LIMIT_GB:
        raise AssertionError(f"{label}: {peak:.2f} GB > {MEM_LIMIT_GB}")
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    return out, counts


def s10_equal(label, got, ref, tol=S10_EQ_TOL):
    """Equal, or within ``tol`` of the peak with the differing cells
    counted and printed."""
    if got.shape != ref.shape:
        raise AssertionError(f"{label}: shape {tuple(got.shape)} != "
                             f"{tuple(ref.shape)}")
    diff = int((got != ref).sum())
    if diff == 0:
        print(f"  {label}: equal ({got.numel()} cells)")
        return 0.0
    err = gate_err(got, ref)
    print(f"  {label}: {diff} of {got.numel()} cells differ")
    check(label, err, tol)
    return err


def s10_mesh():
    n = torch.cuda.device_count()
    devs = [torch.device("cuda", i % n) for i in range(S10_DATA * S10_TIME)]
    mesh = make_mesh(S10_DATA, S10_TIME, devices=devs)
    print(f"  mesh {mesh.shape} over {n} card(s): "
          f"{[[str(d) for d in row] for row in mesh.devices]}")
    return mesh


def s10_mp_batch(device):
    """The two-process batch, made from a seed on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(10)
    n, sec = S10_MP
    return torch.randn((n, sec * SR), generator=g, device=device) * 0.2


def s10_worker(rank, port, out):
    """One process of phase 3g h: its rows of the batch through the sharded
    fused mel on its own mesh (data 1, time 4), the processes' results
    gathered."""
    nproc = 2
    distributed.initialize(f"localhost:{port}", nproc, rank)
    card = rank if distributed.backend() == "nccl" else 0
    dev = torch.device("cuda", card)
    mesh = make_mesh(1, S10_TIME, devices=[dev] * S10_TIME)
    plan = MelSpectrogram(num=NUM, samplate=SR, radix2_exp=R2E,
                          slide_length=SLIDE, device=dev)
    fn = sharded_spectrogram_fn(plan, mesh, with_xxcc=CC, fused=True)
    full = s10_mp_batch(dev)
    rows = full.shape[0] // nproc
    x = distributed.global_from_local(full[rank * rows:(rank + 1) * rows],
                                      mesh, ("data", "time"))
    s10_counts(zero=True)
    mel, cc = fn(x)
    torch.cuda.synchronize()
    launched = fused_mel_mfcc.launches
    mel_g = distributed.process_allgather(mel)
    cc_g = distributed.process_allgather(cc)
    distributed.process_barrier()
    print(f"  worker {rank}: backend {distributed.backend()}, {dev}, "
          f"fused_mel_mfcc launched {launched} times", flush=True)
    if launched < S10_TIME:
        raise AssertionError(f"worker {rank}: {launched} launches")
    if rank == 0:
        torch.save({"mel": mel_g.cpu(), "cc": cc_g.cpu(),
                    "backend": distributed.backend()}, out)


def s10_two_processes(mesh, launches):
    """Phase 3g h: two worker processes of this script against this
    process's sharded call on the same batch."""
    import socket
    import tempfile
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "gathered.pt")
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--s10-worker",
             str(r), str(port), out], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=300)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for r, (p, log) in enumerate(zip(procs, logs)):
            print("\n".join("    " + ln for ln in log.strip().splitlines()
                            if "backend" in ln or "worker" in ln
                            or "Error" in ln))
            if p.returncode != 0:
                raise AssertionError(f"worker {r} exited {p.returncode}:\n"
                                     f"{log[-3000:]}")
        got = torch.load(out)
    plan = MelSpectrogram(num=NUM, samplate=SR, radix2_exp=R2E,
                          slide_length=SLIDE)
    x = s10_mp_batch(torch.device("cuda", 0))
    (mel, cc), _ = s10_call(
        "3g h: the same batch in this process, (data 2, time 4)",
        lambda: sharded_spectrogram_fn(plan, mesh, with_xxcc=CC,
                                       fused=True)(x),
        {"fused_mel_mfcc": S10_DATA * S10_TIME}, 0.0, launches)
    nccl = got["backend"] == "nccl"
    print(f"  3g h: backend {got['backend']}: NCCL "
          f"{'was' if nccl else 'was not'} exercised "
          f"({torch.cuda.device_count()} card(s))")
    s10_equal("gate 3g h two-process mel vs one process", got["mel"],
              mel.cpu())
    s10_equal("gate 3g h two-process cc vs one process", got["cc"], cc.cpu())
    return got["backend"]


def phase3_slice10_paths(gen):
    phase("phase 3g: slice 10, the parallel family on a (data 2, time 4) "
          "mesh")
    mesh = s10_mesh()
    shards = S10_DATA * S10_TIME
    launches = {}
    cpu = {"device": "cpu"}
    d = {"mesh": mesh, "launches": launches}

    def call(label, fn, per_shard, gb):
        return s10_call(label, fn, per_shard, gb, launches)[0]

    # --- a: the headline mel+MFCC, fused per time shard -------------------
    B, sec = S10_HEAD
    n = sec * SR
    x = randn((B, n), gen, 0.2)
    plan = MelSpectrogram(num=NUM, samplate=SR, radix2_exp=R2E,
                          slide_length=SLIDE)
    T = (n - plan.fft_length) // SLIDE + 1
    out_gb = B * (NUM + CC) * T * 4 / 1e9
    in_gb = x.numel() * 4 / 1e9
    fused = sharded_spectrogram_fn(plan, mesh, with_xxcc=CC, fused=True)
    mel, cc = call(f"3g a: sharded fused mel+MFCC, {B} x {sec} s "
                   f"({n // S10_TIME} samples a time block)", lambda: fused(x),
                   {"fused_mel_mfcc": shards},
                   in_gb + out_gb + in_gb / shards)
    um, uc = plan.spectrogram_mfcc_fused(x, cc_num=CC)
    s10_equal("gate 3g a sharded fused mel vs unsharded", mel, um)
    s10_equal("gate 3g a sharded fused cc vs unsharded", cc, uc)
    del um, uc
    err = 0.0
    for i in range(B):
        err = max(err, rel_err(mel[i].cpu(), plan.spectrogram(x[i]).cpu()))
    check("gate 3g a mel vs .spectrogram() on the card, each recording",
          err, GATE_TOL)
    pc = MelSpectrogram(num=NUM, samplate=SR, radix2_exp=R2E,
                        slide_length=SLIDE, **cpu)
    for i in (0, B - 1):
        rm, rc = pc.spectrogram_mfcc_fused(x[i].cpu(), cc_num=CC)
        check(f"gate 3g a recording {i} mel vs CPU", rel_err(mel[i].cpu(), rm),
              GATE_TOL)
        check(f"gate 3g a recording {i} cc vs CPU", rel_err(cc[i].cpu(), rc),
              GATE_TOL)
    del cc
    plain = sharded_spectrogram_fn(plan, mesh, with_xxcc=CC)
    pm, pcc = call("3g a: sharded plain mel+MFCC (fft_pow2 per shard)",
                   lambda: plain(x), {"fft_pow2": shards},
                   in_gb + 2 * out_gb + 6 * in_gb / shards)
    check("gate 3g a plain vs fused sharded mel", rel_err(pm.cpu(), mel.cpu()),
          GATE_TOL)
    del pcc, mel
    t4 = S10_TIME * (T // S10_TIME)
    S = pm[..., :t4]
    stats = call("3g a: sharded spectral stats over the plain mel",
                 lambda: sharded_spectral_stats_fn(mesh)(S), {},
                 2 * out_gb)
    mean = S.double().mean(-1)
    ref = {"sum": S.double().sum(-1), "mean": mean,
           "max": S.amax(-1).double(),
           "var": (S.double() ** 2).mean(-1) - mean ** 2}
    sq_peak = float((S.double() ** 2).mean(-1).max())
    for k in ("sum", "mean", "max", "var"):
        scale = sq_peak if k == "var" else float(ref[k].abs().max())
        check(f"gate 3g a stats {k} vs unsharded (of its peak)",
              float((stats[k].double() - ref[k]).abs().max()) / scale,
              S10_EQ_TOL)
    del pm, S, stats, ref, mean
    d.update(head_x=x, head_plan=plan, head_fused=fused)

    # --- b: STFT -> ISTFT, config 5's plan, 8 x 10 min ---------------------
    B, sec = S10_STFT
    xs = randn((B, sec * SR), gen, 0.2)
    st = STFT(radix2_exp=R2E, window_type=WindowType.HANN,
              slide_length=SLIDE)
    fwd = sharded_stft_fn(mesh, st.fft_length, SLIDE, st.window)
    inv = sharded_istft_fn(mesh, st.fft_length, SLIDE, st.window)
    spec_gb = B * (xs.shape[1] // SLIDE) * (st.fft_length // 2 + 1) * 8 / 1e9
    D = call(f"3g b: sharded STFT, {B} x {sec} s", lambda: fwd(xs),
             {"fft_pow2": shards}, 2 * spec_gb)
    Du = st.stft(xs)
    s10_equal("gate 3g b sharded STFT frames vs STFT.stft", D.transpose(-1, -2),
              Du)
    y = call("3g b: sharded ISTFT", lambda: inv(D), {"fft_inv": shards},
             3 * spec_gb)
    yu = st.istft(Du)
    nf = st.fft_length
    # the edges divide by a window-energy sum that falls to 1e-6 (HANN), so
    # an inverse's rounding there is amplified up to 1e3-fold: the gate
    # holds the interior, the whole length is printed with its worst place
    diff = (y - yu).abs()
    at = int(diff.reshape(-1).argmax()) % y.shape[-1]
    print(f"  3g b sharded ISTFT vs .istft over the whole length: "
          f"{float(diff.max()) / float(yu.abs().max()):.3e} of the peak, "
          f"worst at sample {at} of {y.shape[-1]}")
    check("gate 3g b sharded ISTFT vs .istft, interior (of the peak)",
          rel_err(y[:, nf:-nf].cpu(), yu[:, nf:-nf].cpu()), S10_EQ_TOL)
    del diff
    err = float((y[:, nf:-nf] - xs[:, nf:-nf]).abs().max())
    check("gate 3g b round trip interior (absolute)", err, 1e-3)
    del D, Du, y, yu
    d.update(stft_x=xs, stft_fwd=fwd, stft_inv=inv, stft=st)

    # --- c: the wavelet family at config 4's width ------------------------
    n = 1 << WAV_R2E
    xw = randn((S10_WAV_CLIPS, n), gen, 0.2)
    cwt = CWT(**WAV_KW, wavelet_type=WaveletContinueType.MORLET,
              scale_type=OCTAVE)
    sq = Synsq(num=WAV_NUM, radix2_exp=WAV_R2E, samplate=SR)
    ws = WSST(**WAV_KW, wavelet_type=WaveletContinueType.MORLET,
              scale_type=OCTAVE)
    pw = PWT(**WAV_KW)
    wav_gb = S10_WAV_CLIPS * WAV_NUM * n * 8 / 1e9
    f_cwt = sharded_cwt_fn(cwt, mesh)
    W = call(f"3g c: sharded CWT, {S10_WAV_CLIPS} x {n}, "
             f"{WAV_NUM // S10_TIME} bands a shard", lambda: f_cwt(xw),
             {"cwt_ifft_bank": shards}, 3 * wav_gb)
    check("gate 3g c sharded CWT vs CWT.cwt", gate_err(W, cwt.cwt(xw)),
          S10_EQ_TOL)
    Wd = call("3g c: sharded cwt_det", lambda: sharded_cwt_fn(
        cwt, mesh, det=True)(xw), {"cwt_ifft_bank": shards}, 3 * wav_gb)
    check("gate 3g c sharded cwt_det vs CWT.cwt_det",
          gate_err(Wd, cwt.cwt_det(xw)), S10_EQ_TOL)
    del Wd
    P = call("3g c: sharded PWT", lambda: sharded_pwt_fn(pw, mesh)(xw),
             {"cwt_ifft_bank": shards}, 3 * wav_gb)
    check("gate 3g c sharded PWT vs PWT.pwt", gate_err(P, pw.pwt(xw)),
          S10_EQ_TOL)
    del P
    f_sq = sharded_synsq_fn(cwt, sq, mesh)
    Y = call("3g c: sharded CWT -> synsq", lambda: f_sq(xw),
             {"cwt_ifft_bank": shards, "synsq_bins": shards,
              "columnar_scatter": shards}, 4 * wav_gb)
    flips_and_mass("gate 3g c sharded synsq vs unsharded", Y.abs(),
                   sq.synsq(W, OCTAVE, cwt.get_fre_band_arr()).abs())
    del Y
    (Q, Dq) = call("3g c: sharded WSST", lambda: sharded_wsst_fn(ws, mesh)(xw),
                   {"cwt_ifft_bank": 2 * shards, "columnar_scatter": shards},
                   5 * wav_gb)
    Qu, Du = ws.wsst(xw)
    check("gate 3g c sharded WSST cwt vs unsharded", gate_err(Dq, Du),
          S10_EQ_TOL)
    flips_and_mass("gate 3g c sharded WSST vs unsharded", Q.abs(), Qu.abs())
    del Q, Dq, Qu, Du, W
    Bc, nc = S10_CCWT
    xl = randn((Bc, nc), gen, 0.2)
    cc_gb = Bc * WAV_NUM * nc * 8 / 1e9
    C = call(f"3g c: sharded ccwt, {Bc} x {nc}", lambda: sharded_ccwt_fn(
        cwt, mesh)(xl), {"cwt_ifft_bank": shards}, 3 * cc_gb)
    check("gate 3g c sharded ccwt vs CWT.ccwt", gate_err(C, cwt.ccwt(xl)),
          S10_EQ_TOL)
    del C, xl
    d.update(wav_x=xw, cwt=cwt, sq=sq, f_cwt=f_cwt, f_sq=f_sq)

    # --- d: the full-signal twins at slice 8's extractor widths ----------
    L = 1 << FE_R2E
    xf = fe_signal(S10_FE_CLIPS, L, gen)
    objs = FeatureExtractor(["st", "fst", "nsgt"], radix2_exp=FE_R2E,
                            samplate=SR)._objs
    st_obj, fst_obj, ns = objs["st"], objs["fst"], objs["nsgt"]
    st_gb = S10_FE_CLIPS * len(st_obj.bin_arr) * L * 8 / 1e9
    got = call(f"3g d: sharded ST, {S10_FE_CLIPS} x {L}",
               lambda: sharded_st_fn(st_obj, mesh)(xf),
               {"fft_pow2": shards, "fft_inv": shards}, 4 * st_gb)
    check("gate 3g d sharded ST vs ST.st", gate_err(got, st_obj.st(xf)),
          2e-6)
    del got
    got = call("3g d: sharded FST", lambda: sharded_fst_fn(fst_obj, mesh)(xf),
               {"fft_pow2": shards}, 2 * st_gb)
    ref = fst_obj.fst(xf)
    if not torch.equal(got, ref):
        raise AssertionError("3g d: sharded FST is not bit-equal to FST.fst")
    print("  gate 3g d sharded FST vs FST.fst: equal")
    del got, ref
    got = call("3g d: sharded NSGT", lambda: sharded_nsgt_fn(ns, mesh)(xf),
               {"fft_pow2": shards}, 1.0)
    check("gate 3g d sharded NSGT vs NSGT.nsgt", gate_err(got, ns.nsgt(xf)),
          5e-6)
    Bs, ns_ = S10_CST
    xc = fe_signal(Bs, ns_, gen)
    cst_gb = Bs * len(st_obj.bin_arr) * ns_ * 8 / 1e9
    got = call(f"3g d: sharded cst, {Bs} x {ns_}",
               lambda: sharded_cst_fn(st_obj, mesh)(xc),
               {"fft_pow2": shards, "fft_inv": shards}, 4 * cst_gb)
    check("gate 3g d sharded cst vs ST.cst", gate_err(got, st_obj.cst(xc)),
          2e-6)
    del got, xc
    xq = fe_signal(S10_CQT_CLIPS, C3_N, gen)
    cq = CQT(num=84, samplate=SR, slide_length=C3_SLIDE)
    got = call(f"3g d: sharded CQT (batch over the {shards} shards), "
               f"{S10_CQT_CLIPS} x {C3_N}",
               lambda: sharded_cqt_fn(cq, mesh)(xq), {}, 1.0)
    check("gate 3g d sharded CQT vs CQT.cqt", gate_err(got, cq.cqt(xq)), 2e-6)
    del got, xq, xf

    # --- e: config 5's MIR calls through the batch map ---------------------
    B, sec = S10_MIR
    xm = mir_signal(B, sec * SR, gen)
    hp = HPSS(radix2_exp=R2E, window_type=WindowType.HAMM, slide_length=SLIDE,
              h_order=H_ORDER, p_order=P_ORDER)
    yin = PitchYIN(samplate=SR, radix2_exp=YIN_R2E, slide_length=YIN_SLIDE)
    f_hp = sharded_batch_map_fn(hp.hpss, mesh)
    f_yin = sharded_batch_map_fn(yin.pitch, mesh)
    h, p = call(f"3g e: HPSS.hpss through the batch map, {B} x {sec} s",
                lambda: f_hp(xm), {"fft_pow2": S10_DATA, "fft_inv": S10_DATA,
                                   "median_filter": S10_DATA}, 20.0)
    h0, p0 = hp.hpss(xm)
    s10_equal("gate 3g e batch-mapped HPSS h vs unsharded", h, h0, 0.0)
    s10_equal("gate 3g e batch-mapped HPSS p vs unsharded", p, p0, 0.0)
    del h, p, h0, p0
    got = call("3g e: PitchYIN.pitch through the batch map", lambda: f_yin(xm),
               {"fft_autocorr_yin": S10_DATA}, 4.0)
    ref = yin.pitch(xm)
    for a, b in zip(got, ref):
        s10_equal("gate 3g e batch-mapped YIN vs unsharded", a, b, 0.0)
    del got, ref
    d.update(mir_x=xm, f_hp=f_hp, f_yin=f_yin, hp=hp, yin=yin)

    # --- f: the headline chain in four pipeline stages ---------------------
    B, T = S10_PIPE
    nfft = plan.fft_length
    n = (T - 1) * SLIDE + nfft
    xp = randn((B, n), gen, 0.2)
    win, fb = plan._window_t, plan._fb_t
    stages = [lambda v: (v.unfold(-1, nfft, SLIDE) * win).contiguous(),
              lambda v: (lambda s: s.real.square() + s.imag.square())(
                  rfft(v, dim=-1)),
              lambda v: torch.matmul(v, fb.T),
              lambda v: torch.log10(torch.clamp(v, min=1e-8))]
    shapes = [(n,), (T, nfft), (T, nfft // 2 + 1), (T, NUM), (T, NUM)]
    pipe = pipeline_chain_fn(stages, shapes, mesh, axis="time",
                             n_micro=S10_TIME)
    got = call(f"3g f: the headline chain in {S10_TIME} pipeline stages, "
               f"{B} x T={T}", lambda: pipe(xp), {"fft_pow2": S10_TIME},
               3 * B * T * nfft * 4 / 1e9 / S10_TIME)
    want = xp
    for fn in stages:
        want = fn(want)
    print(f"  gate 3g f pipeline vs direct composition: "
          f"{gate_err(got, want):.3e} of the peak")
    torch.testing.assert_close(got, want, rtol=2e-6,
                               atol=2e-6 * float(want.abs().max()))
    del got, want, xp

    # --- g: BatchRunner over 16 WAV files of 30 s ------------------------
    import tempfile
    nf, sec = S10_FILES
    clip = (sec * SR // (S10_TIME * SLIDE)) * S10_TIME * SLIDE
    xr = mir_signal(nf, sec * SR, gen).clamp(-1.0, 1.0).cpu().numpy()
    tmp = tempfile.mkdtemp(prefix="af_s10_")
    paths = []
    for i in range(nf):
        pth = os.path.join(tmp, f"clip{i:02d}.wav")
        wave_write(pth, xr[i], SR)
        paths.append(pth)
    runner = BatchRunner(plan, mesh, clip_length=clip, with_xxcc=CC)
    (rs, rc), good = call(f"3g g: BatchRunner.run_files, {nf} files of "
                          f"{sec} s", lambda: runner.run_files(paths),
                          {"fft_pow2": shards}, 1.0)
    if good != nf:
        raise AssertionError(f"3g g: {good} of {nf} files decoded")
    decoded = np.stack([wave_read(pth)[0][:clip] for pth in paths])
    rs2, rc2 = runner.run_array(decoded)
    s10_equal("gate 3g g run_files vs run_array of the decoded batch", rs, rs2,
              0.0)
    s10_equal("gate 3g g run_files cc vs run_array", rc, rc2, 0.0)
    out_dir = os.path.join(tmp, "out")
    half = nf // 2
    n1 = runner.run_files_resumable(paths, out_dir, chunk_size=half,
                                    max_chunks=1)
    n2 = runner.run_files_resumable(paths, out_dir, chunk_size=half)
    n3 = runner.run_files_resumable(paths, out_dir, chunk_size=half)
    with open(os.path.join(out_dir, "manifest.jsonl")) as fh:
        done = [json.loads(ln)["path"] for ln in fh if ln.strip()]
    print(f"  3g g resumable: (done, skipped) {n1}, {n2}, {n3}; manifest "
          f"{len(done)} entries")
    if (n1, n2, n3) != ((half, 0), (nf - half, half), (0, nf)) or \
            sorted(done) != sorted(paths):
        raise AssertionError("3g g: the files were not each done once")
    for lo in (0, half):
        (ref, _), _ = runner.run_files(paths[lo:lo + half])
        saved = torch.from_numpy(np.stack([np.load(os.path.join(
            out_dir, os.path.splitext(os.path.basename(pth))[0] + ".npy"))
            for pth in paths[lo:lo + half]]))
        s10_equal(f"gate 3g g resumed files {lo}..{lo + half - 1} vs "
                  "run_files", saved, ref.cpu(), 0.0)
    d.update(runner=runner, paths=paths, tmp=tmp)

    # --- h: two processes ---------------------------------------------------
    d["mp_backend"] = s10_two_processes(mesh, launches)

    # --- i: the dry run ------------------------------------------------------
    call("3g i: dryrun_multichip(8) over the mesh's devices",
         lambda: dryrun_multichip(shards, devices=list(mesh.devices.flat)),
         {"fused_mel_mfcc": shards}, 1.0)
    print(f"  launches on the slice-10 paths: "
          f"{ {k: v for k, v in launches.items() if v} }")
    return d


def phase4_slice10_timing(d):
    phase("phase 4g: slice 10 timing (CUDA events, median)")
    mesh = d["mesh"]
    shards = S10_DATA * S10_TIME
    shapes = {}
    one = len({str(v) for v in mesh.devices.flat}) == 1

    def reading(name, source, replaces, launches, err, k_ms, p_ms, l_ms,
                n_bytes, n_ops, what, entry=None):
        """A kernel's reading at one shard's shape, for its ``shapes``."""
        row = kernel_row(name, source, replaces, launches, err, k_ms, p_ms,
                         l_ms, n_bytes, n_ops, what, entry=entry)
        shapes.setdefault(name, []).append(dict(
            shape=(f"{entry}: " if entry else "") + what,
            **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "max_abs_err")}))
    print(f"  {'one card: these times measure the split, the halos and the '
           'assembly, not scaling' if one else 'several cards'}")

    def versus(label, sharded, unsharded, hours):
        s_ms = cuda_ms(sharded, reps=3, warmup=1)
        u_ms = cuda_ms(unsharded, reps=3, warmup=1)
        print(f"  {label}: sharded {s_ms:.3f} ms = {hours / (s_ms / 1e3):.3f} "
              f"audio-hours/s; unsharded {u_ms:.3f} ms = "
              f"{hours / (u_ms / 1e3):.3f}; sharded / unsharded "
              f"{s_ms / u_ms:.3f}")
        return s_ms, u_ms

    # --- a: the headline, fused --------------------------------------------
    x, plan, fused = d["head_x"], d["head_plan"], d["head_fused"]
    hours = x.numel() / SR / 3600.0
    versus(f"3g a fused mel+MFCC {tuple(x.shape)}", lambda: fused(x),
           lambda: plan.spectrogram_mfcc_fused(x, cc_num=CC), hours)
    halo = plan.fft_length - SLIDE
    halo_bytes = shards * (x.shape[0] // S10_DATA) * halo * 4
    def split_only():
        for *_, blk in _time_blocks(x, mesh, "data", "time", SLIDE, halo,
                                    "halo")[1]:
            del blk
    blocks_ms = cuda_ms(split_only, reps=3, warmup=1)
    print(f"  3g a halos: {halo_bytes} bytes ({halo} samples x "
          f"{x.shape[0] // S10_DATA} rows x {shards} shards); the split with "
          f"its halo copies and the blocks' copies (each block and its halo "
          f"into one buffer, {x.numel() * 4 / 1e9:.2f} GB in all): "
          f"{blocks_ms:.3f} ms")
    # the fused kernel at one shard's shape
    fplan = FusedMelPlan(plan.window, plan.filter_bank, plan._dct[:CC], SLIDE)
    n_loc = x.shape[1] // S10_TIME
    b_loc = x.shape[0] // S10_DATA
    ext = x[:b_loc, :n_loc + halo].contiguous()
    T = n_loc // SLIDE
    k_ms = cuda_ms(lambda: fused_mel_mfcc(fplan, ext), reps=5)
    p_ms = cuda_ms(chunked(lambda t: fused_mel_mfcc_ref(fplan, t), (ext,), 1),
                   reps=2, warmup=1)
    l_ms = cuda_ms(lambda: fused_mel_mfcc_ref(fplan, ext), reps=2, warmup=1)
    err = gate_err(fused_mel_mfcc(fplan, ext)[0],
                   fused_mel_mfcc_ref(fplan, ext)[0])
    nfft = plan.fft_length
    reading("fused_mel_mfcc", "fused_mel_mfcc",
            "audioflux_tpu/ops/pallas_spectrogram.py:1250", 0, err,
            k_ms, p_ms, l_ms, 4 * (ext.numel() + b_loc * (NUM + CC) * T),
            b_loc * T * (2.5 * nfft * math.log2(nfft)
                         + 2 * fplan.band_nnz + NUM + 2 * CC * NUM),
            f"one time shard: {b_loc}x{ext.shape[1]} -> {T} frames")
    del ext

    # --- b: STFT and ISTFT ------------------------------------------------
    xs, st = d["stft_x"], d["stft"]
    hours = xs.numel() / SR / 3600.0
    versus(f"3g b STFT {tuple(xs.shape)}", lambda: d["stft_fwd"](xs),
           lambda: st.stft(xs), hours)
    D = d["stft_fwd"](xs)
    Du = D.transpose(-1, -2)
    versus("3g b ISTFT", lambda: d["stft_inv"](D), lambda: st.istft(Du),
           hours)
    # the FFT kernels at one shard's shape
    b_loc = xs.shape[0] // S10_DATA
    n_loc = xs.shape[1] // S10_TIME
    ext = xs[:b_loc, :n_loc + halo]
    frames = (ext.unfold(-1, nfft, SLIDE) * st._window_t).contiguous()
    nrows = frames.numel() // nfft
    fops = nrows * 5.0 * nfft * math.log2(nfft)
    k_ms = cuda_ms(lambda: fft_fwd(frames), reps=10)
    p_ms = cuda_ms(chunked(fft_fwd_ref, (frames,), 1), reps=3, warmup=1)
    l_ms = cuda_ms(lambda: torch.fft.fft(frames, dim=-1), reps=5)
    reading("fft_pow2", "fft_pow2",
            "audioflux_tpu/ops/pallas_fft.py:346", 0,
            pair_rel(fft_fwd(frames), fft_fwd_ref(frames)), k_ms,
            p_ms, l_ms, 12 * frames.numel(), fops,
            f"forward {nrows}x{nfft} real, one STFT shard's frames")
    T_loc = nrows // b_loc
    half = D[:b_loc, :T_loc].contiguous()
    vr, vi = half.real.contiguous(), half.imag.clone()
    vi[..., 0] = 0
    vi[..., -1] = 0
    yr = torch.cat([vr, vr[..., 1:nfft // 2].flip(-1)], dim=-1).contiguous()
    yi = torch.cat([vi, -vi[..., 1:nfft // 2].flip(-1)], dim=-1).contiguous()
    k_ms = cuda_ms(lambda: fft_inv(yr, yi, out_imag=False), reps=10)
    p_ms = cuda_ms(chunked(lambda a, b: fft_inv_ref(a, b, out_imag=False),
                           (yr, yi), 1), reps=3, warmup=1)
    l_ms = cuda_ms(lambda: torch.fft.irfft(half, n=nfft, dim=-1), reps=5)
    reading("fft_inv", "fft_pow2",
            "audioflux_tpu/ops/pallas_fft.py:360", 0,
            pair_rel(fft_inv(yr, yi, out_imag=False)[:1],
                     fft_inv_ref(yr, yi, out_imag=False)[:1]),
            k_ms, p_ms, l_ms, 12 * yr.numel(), fops,
            f"{b_loc * T_loc}x{nfft} real output, one ISTFT "
            "shard's frames")
    del D, Du, frames, half, vr, vi, yr, yi

    # --- c: the wavelet family ----------------------------------------------
    xw, cwt, sq = d["wav_x"], d["cwt"], d["sq"]
    hours = xw.numel() / SR / 3600.0
    versus(f"3g c CWT {tuple(xw.shape)}", lambda: d["f_cwt"](xw),
           lambda: cwt.cwt(xw), hours)
    versus("3g c CWT -> synsq", lambda: d["f_sq"](xw),
           lambda: sq.synsq(cwt.cwt(xw), OCTAVE, cwt.get_fre_band_arr()),
           hours)
    # the wavelet kernels at one band shard's shape
    n, p = 1 << WAV_R2E, cwt.pad_length
    N = n + 2 * p
    b_loc = xw.shape[0] // S10_DATA
    nb = -(-WAV_NUM // S10_TIME)
    bank = cwt._bank_t[:nb].contiguous()
    row_h = torch.tensor(band_row_counts(cwt._bank[:nb], N), dtype=torch.int32,
                         device="cuda")
    Fb = torch.fft.fft(_symmetric_pad(xw[:b_loc], p), dim=-1)
    k_ms = cuda_ms(lambda: cwt_ifft_bank(Fb, bank, pad=p, length=n,
                                         row_h=row_h), reps=10)
    p_ms = cuda_ms(chunked(lambda t: cwt_ifft_bank_ref(t, bank, pad=p,
                                                       length=n), (Fb,), 1),
                   reps=3, warmup=1)
    l_ms = cuda_ms(lambda: torch.fft.ifft(bank * Fb[:, None, :], dim=-1)[
        ..., p:p + n], reps=5)
    Wl = cwt_ifft_bank(Fb, bank, pad=p, length=n, row_h=row_h)
    cells = b_loc * nb * n
    reading("cwt_ifft_bank", "cwt_ifft_bank",
            "audioflux_tpu/ops/pallas_cwt.py:183", 0,
            gate_err(Wl, cwt_ifft_bank_ref(Fb, bank, pad=p, length=n)),
            k_ms, p_ms, l_ms, 8 * b_loc * N + 4 * nb * N + 8 * cells,
            b_loc * nb * 5.0 * N * math.log2(N),
            f"one band shard: {b_loc}x{nb} band-rows, N={N}")
    fre_t = torch.from_numpy(np.asarray(cwt.fre_band_arr, np.float32)).to("cuda")
    bins_ms = cuda_ms(lambda: synsq_bins(Wl, fre_t, "log", WAV_NUM, float(SR),
                                         sq.thresh), reps=10)
    p_ms = cuda_ms(chunked(lambda v: synsq_bins_ref(
        v, fre_t, "log", WAV_NUM, float(SR), sq.thresh), (Wl,), 1), reps=3,
        warmup=1)
    fi = synsq_bins(Wl, fre_t, "log", WAV_NUM, float(SR), sq.thresh)
    diff = int((fi != synsq_bins_ref(Wl, fre_t, "log", WAV_NUM, float(SR),
                                     sq.thresh)).sum())
    print(f"  synsq_bins at one band shard: {diff} of {fi.numel()} bins "
          "differ from the plain version")
    reading("unwrap_diff", "unwrap_diff",
            "audioflux_tpu/ops/pallas_unwrap.py:102", 0,
            diff / fi.numel(), bins_ms, p_ms, None, 12 * cells,
            60.0 * cells, f"one band shard: {b_loc}x{nb}x{n} cells "
            "-> bins", entry="synsq_bins")
    k_ms = cuda_ms(lambda: columnar_scatter(Wl, fi, WAV_NUM), reps=10)
    p_ms = cuda_ms(chunked(lambda v, f: columnar_scatter_ref(v, f, WAV_NUM),
                           (Wl, fi), 1), reps=2, warmup=1)

    def lib_scatter(v, f):
        buf = torch.zeros((v.shape[0], WAV_NUM + 1, n, 2), device="cuda")
        buf.scatter_add_(1, f.long()[..., None].expand(*f.shape, 2),
                         torch.view_as_real(v))
    l_ms = cuda_ms(lambda: lib_scatter(Wl, fi), reps=5)
    same = torch.equal(columnar_scatter(Wl, fi, WAV_NUM),
                       columnar_scatter_ref(Wl, fi, WAV_NUM))
    if not same:
        raise AssertionError("columnar_scatter differs at one band shard")
    reading("columnar_scatter", "columnar_scatter",
            "audioflux_tpu/ops/pallas_scatter.py:71", 0,
            0.0, k_ms, p_ms, l_ms,
            (12 + 8) * cells, 2.0 * cells,
            f"one band shard: {b_loc} x {nb} -> {WAV_NUM} x {n}")
    del Fb, Wl, fi

    # --- e: the batch map ----------------------------------------------------
    xm, hp, yin = d["mir_x"], d["hp"], d["yin"]
    hours = xm.numel() / SR / 3600.0
    versus(f"3g e HPSS.hpss {tuple(xm.shape)}", lambda: d["f_hp"](xm),
           lambda: hp.hpss(xm), hours)
    versus("3g e PitchYIN.pitch", lambda: d["f_yin"](xm),
           lambda: yin.pitch(xm), hours)

    # --- g: BatchRunner, host clock --------------------------------------
    runner, paths = d["runner"], d["paths"]
    metrics.reset()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.run_files(paths)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    rep = metrics.report()
    wall = sorted(times)[1]
    load = rep["af.load_batch.seconds"] / rep["af.load_batch.calls"]
    print(f"  3g g BatchRunner.run_files, {len(paths)} files (host clock, "
          f"median of 3): {wall * 1e3:.1f} ms = {len(paths) / wall:.1f} "
          f"files/s; the loader {load * 1e3:.1f} ms of it "
          f"({rep['af.load_batch.calls']} calls), the sharded mel "
          f"{rep['af.run_array.seconds'] / rep['af.run_array.calls'] * 1e3:.1f}"
          " ms")
    shutil.rmtree(d["tmp"], ignore_errors=True)
    return shapes


# --- slice 12: sharded results kept on their devices, sharded inputs that
# chain, Synsq's reduce-scatter and the frame-sharded CQT ------------------
#
# On phase 3g's mesh and inputs.  Every sharded function runs kept
# beside its default call: each part on its mesh device, gather()
# torch.equal to the default result.  The chains (STFT -> ISTFT,
# spectrogram -> spectral stats) run on ShardedTensors with every
# Assembler.put and gather counted: none may run.  The frame-form CQT
# (mode="gspmd") on one clip of S12_CQT_SECONDS at 32 kHz against the
# unsharded cqt at S12_CQT_TOL of the peak.  The stats chain's plan slides
# S12_STATS_SLIDE samples, so that the spectrogram's valid frames divide
# the time axis as the default stats ask (4 * (slots - 1)).
S12_CQT_SECONDS, S12_CQT_TOL, S12_STATS_SLIDE = 600, 1e-5, 448


@contextlib.contextmanager
def s12_copy_counts():
    """Counts, inside the block, every copy into one assembled tensor:
    ``Assembler.put``, the parallel modules' ``gather`` and
    ``ShardedTensor.gather``."""
    counts = {"Assembler.put": 0, "gather": 0, "ShardedTensor.gather": 0}

    def counted(key, fn):
        def wrapper(*a, **k):
            counts[key] += 1
            return fn(*a, **k)
        return wrapper
    saved = [(_shard.Assembler, "put", _shard.Assembler.put),
             (ShardedTensor, "gather", ShardedTensor.gather)]
    saved += [(mod, "gather", mod.gather) for mod in (_shard, sharded_full_mod)]
    _shard.Assembler.put = counted("Assembler.put", _shard.Assembler.put)
    ShardedTensor.gather = counted("ShardedTensor.gather",
                                   ShardedTensor.gather)
    for mod in (_shard, sharded_full_mod):
        mod.gather = counted("gather", mod.gather)
    try:
        yield counts
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)


def s12_no_copies(label, counts):
    print(f"  gate 3g j {label}: copies into one tensor {counts}")
    if any(counts.values()):
        raise AssertionError(f"{label}: the chain assembled a result")


def s12_kept(label, kept, default):
    """Each part of the kept result on its mesh device; gather() equal to
    the default call's result (``kept``/``default`` may be nests)."""
    if isinstance(default, dict):
        for k in default:
            s12_kept(f"{label} [{k}]", kept[k], default[k])
        return
    if isinstance(default, (tuple, list)):
        for k, (a, b) in enumerate(zip(kept, default)):
            s12_kept(f"{label} [{k}]", a, b)
        return
    if not isinstance(kept, ShardedTensor):
        raise AssertionError(f"{label}: {type(kept).__name__}, not a "
                             "ShardedTensor")
    for s in kept.shards:
        if s.data.device != kept.mesh.devices[s.position]:
            raise AssertionError(f"{label}: the part at {s.position} lies on "
                                 f"{s.data.device}")
    got = kept.gather()
    if got.shape != default.shape or not torch.equal(got, default):
        diff = int((got != default).sum()) if got.shape == default.shape \
            else "shape"
        raise AssertionError(f"{label}: gather() differs from the default "
                             f"call ({diff} cells)")
    print(f"  gate 3g j {label}: {len(kept.shards)} parts {kept.spec} on "
          f"their mesh devices; gather() equal ({got.numel()} cells)")


def phase3_slice12_paths(d, gen):
    phase("phase 3g j: slice 12, sharded results kept on their devices")
    mesh, launches = d["mesh"], d["launches"]
    shards = S10_DATA * S10_TIME
    s12 = {"pairs": []}

    def call(label, fn, per_shard, gb):
        return s10_call(label, fn, per_shard, gb, launches)[0]

    def pair(label, default, kept, per_shard, gb, hours=None):
        """The kept call through its counts, against the default call;
        both kept for 4g's timing."""
        got = call(f"3g j: {label}, kept", kept, per_shard, gb)
        s12_kept(label, got, default())
        s12["pairs"].append((label, default, kept, hours))
        return got

    # --- the halo-sharded family on 3g a's recordings ---------------------
    x, plan = d["head_x"], d["head_plan"]
    hours = x.numel() / SR / 3600.0
    fused_k = sharded_spectrogram_fn(plan, mesh, with_xxcc=CC, fused=True,
                                     keep_sharded=True)
    out_gb = x.numel() * (NUM + CC) / SLIDE * 4 / 1e9
    pair("sharded fused mel+MFCC", lambda: d["head_fused"](x),
         lambda: fused_k(x), {"fused_mel_mfcc": shards}, 2 * out_gb, hours)
    plain = sharded_spectrogram_fn(plan, mesh, with_xxcc=CC)
    plain_k = sharded_spectrogram_fn(plan, mesh, with_xxcc=CC,
                                     keep_sharded=True)
    pair("sharded plain mel+MFCC", lambda: plain(x), lambda: plain_k(x),
         {"fft_pow2": shards}, 4 * out_gb, hours)
    # the chain spectrogram -> spectral stats, slide 448
    blk = S10_TIME * S12_STATS_SLIDE
    x4 = x[:, :x.shape[1] // blk * blk]
    p448 = MelSpectrogram(num=NUM, samplate=SR, radix2_exp=R2E,
                          slide_length=S12_STATS_SLIDE)
    spec_k = sharded_spectrogram_fn(p448, mesh, keep_sharded=True)
    stats_k = sharded_spectral_stats_fn(mesh, keep_sharded=True)
    with s12_copy_counts() as counts:
        st = call("3g j: chain spectrogram -> spectral stats on "
                  "ShardedTensors", lambda: stats_k(spec_k(x4)),
                  {"fft_pow2": shards}, 4 * out_gb)
    s12_no_copies("chain spectrogram -> stats", counts)
    spec_d = sharded_spectrogram_fn(p448, mesh)(x4)
    ref = sharded_spectral_stats_fn(mesh)(spec_d)
    sq_peak = float(((spec_d.double() ** 2).mean(-1)).max())
    for k in ("sum", "mean", "max", "var"):
        got = st[k].gather()
        scale = sq_peak if k == "var" else float(ref[k].abs().max())
        err = float((got.double() - ref[k].double()).abs().max()) / scale
        print(f"  3g j chain stats {k}: {int((got != ref[k]).sum())} of "
              f"{got.numel()} cells differ from the gathered chain")
        check(f"gate 3g j chain stats {k} vs the gathered chain (of its "
              "peak; var of E[S^2]'s)", err, S10_EQ_TOL)
    del st, spec_d, ref
    s12["pairs"].append(("chain spectrogram -> stats (slide 448)",
                         lambda: sharded_spectral_stats_fn(mesh)(
                             sharded_spectrogram_fn(p448, mesh)(x4)),
                         lambda: stats_k(spec_k(x4)), hours))

    # --- STFT -> ISTFT on 3g b's recordings ---------------------------------
    xs, stp = d["stft_x"], d["stft"]
    hours = xs.numel() / SR / 3600.0
    fwd_k = sharded_stft_fn(mesh, stp.fft_length, SLIDE, stp.window,
                            keep_sharded=True)
    inv_k = sharded_istft_fn(mesh, stp.fft_length, SLIDE, stp.window,
                             keep_sharded=True)
    spec_gb = xs.numel() / SLIDE * (stp.fft_length // 2 + 1) * 8 / 1e9
    with s12_copy_counts() as counts:
        Dk = call("3g j: sharded STFT, kept", lambda: fwd_k(xs),
                  {"fft_pow2": shards}, 2 * spec_gb)
        yk = call("3g j: sharded ISTFT on the kept STFT", lambda: inv_k(Dk),
                  {"fft_inv": shards}, 3 * spec_gb)
    s12_no_copies("chain STFT -> ISTFT", counts)
    D = d["stft_fwd"](xs)
    s12_kept("sharded STFT", Dk, D)
    y = d["stft_inv"](D)
    s10_equal("gate 3g j chain STFT -> ISTFT vs the gathered chain",
              yk.gather(), y)
    del Dk, yk, D, y
    s12["pairs"].append(("sharded STFT", lambda: d["stft_fwd"](xs),
                         lambda: fwd_k(xs), hours))
    s12["pairs"].append(("chain STFT -> ISTFT",
                         lambda: d["stft_inv"](d["stft_fwd"](xs)),
                         lambda: inv_k(fwd_k(xs)), hours))
    xg = distributed.global_from_local(xs, mesh, ("data", "time"),
                                       keep_sharded=True)
    s12_kept("global_from_local (data, time)",
             xg, distributed.global_from_local(xs, mesh, ("data", "time")))
    pair("sharded STFT on global_from_local's ShardedTensor",
         lambda: d["stft_fwd"](xs), lambda: fwd_k(xg), {"fft_pow2": shards},
         2 * spec_gb, hours)

    # --- the wavelet family on 3g c's clips --------------------------------
    xw, cwt, sq = d["wav_x"], d["cwt"], d["sq"]
    hours = xw.numel() / SR / 3600.0
    wav_gb = xw.numel() * WAV_NUM * 8 / 1e9
    ws = WSST(**WAV_KW, wavelet_type=WaveletContinueType.MORLET,
              scale_type=OCTAVE)
    pw = PWT(**WAV_KW)
    bank = {"cwt_ifft_bank": shards}
    for label, default, kept, per_shard in (
            ("sharded CWT", d["f_cwt"],
             sharded_cwt_fn(cwt, mesh, keep_sharded=True), bank),
            ("sharded cwt_det", sharded_cwt_fn(cwt, mesh, det=True),
             sharded_cwt_fn(cwt, mesh, det=True, keep_sharded=True), bank),
            ("sharded PWT", sharded_pwt_fn(pw, mesh),
             sharded_pwt_fn(pw, mesh, keep_sharded=True), bank),
            ("sharded CWT -> synsq, reduce-scattered", d["f_sq"],
             sharded_synsq_fn(cwt, sq, mesh, keep_sharded=True),
             {"cwt_ifft_bank": shards, "synsq_bins": shards,
              "columnar_scatter": shards}),
            ("sharded WSST, reduce-scattered", sharded_wsst_fn(ws, mesh),
             sharded_wsst_fn(ws, mesh, keep_sharded=True),
             {"cwt_ifft_bank": 2 * shards, "columnar_scatter": shards})):
        pair(label, lambda f=default: f(xw), lambda f=kept: f(xw), per_shard,
             5 * wav_gb, hours)
    Bc, nc = S10_CCWT
    xl = randn((Bc, nc), gen, 0.2)
    cc_gb = Bc * WAV_NUM * nc * 8 / 1e9
    f_cc = sharded_ccwt_fn(cwt, mesh)
    f_cck = sharded_ccwt_fn(cwt, mesh, keep_sharded=True)
    pair(f"sharded ccwt, {Bc} x {nc}", lambda: f_cc(xl), lambda: f_cck(xl),
         bank, 3 * cc_gb, xl.numel() / SR / 3600.0)

    # --- the full-signal twins on slice 8's widths, CQT ---------------------
    L = 1 << FE_R2E
    xf = fe_signal(S10_FE_CLIPS, L, gen)
    hours = xf.numel() / SR / 3600.0
    objs = FeatureExtractor(["st", "fst", "nsgt"], radix2_exp=FE_R2E,
                            samplate=SR)._objs
    st_obj, fst_obj, ns = objs["st"], objs["fst"], objs["nsgt"]
    st_gb = S10_FE_CLIPS * len(st_obj.bin_arr) * L * 8 / 1e9
    for label, make, per_shard, gb in (
            ("sharded ST", lambda k: sharded_st_fn(st_obj, mesh,
                                                   keep_sharded=k),
             {"fft_pow2": shards, "fft_inv": shards}, 4 * st_gb),
            ("sharded FST", lambda k: sharded_fst_fn(fst_obj, mesh,
                                                     keep_sharded=k),
             {"fft_pow2": shards}, 2 * st_gb),
            ("sharded NSGT", lambda k: sharded_nsgt_fn(ns, mesh,
                                                       keep_sharded=k),
             {"fft_pow2": shards}, 1.0)):
        pair(label, lambda f=make(False): f(xf), lambda f=make(True): f(xf),
             per_shard, gb, hours)
    Bs, ns_ = S10_CST
    xc = fe_signal(Bs, ns_, gen)
    cst_gb = Bs * len(st_obj.bin_arr) * ns_ * 8 / 1e9
    f_cs = sharded_cst_fn(st_obj, mesh)
    f_csk = sharded_cst_fn(st_obj, mesh, keep_sharded=True)
    pair(f"sharded cst, {Bs} x {ns_}", lambda: f_cs(xc), lambda: f_csk(xc),
         {"fft_pow2": shards, "fft_inv": shards}, 4 * cst_gb,
         xc.numel() / SR / 3600.0)
    xq = fe_signal(S10_CQT_CLIPS, C3_N, gen)
    cq = CQT(num=84, samplate=SR, slide_length=C3_SLIDE)
    f_cq, f_cqk = sharded_cqt_fn(cq, mesh), sharded_cqt_fn(
        cq, mesh, keep_sharded=True)
    pair(f"sharded CQT, batch form over the {shards} shards",
         lambda: f_cq(xq), lambda: f_cqk(xq), {}, 1.0,
         xq.numel() / SR / 3600.0)
    # the frame form on one long clip
    x1 = mir_signal(1, S12_CQT_SECONDS * SR, gen)
    f_fr = sharded_cqt_fn(cq, mesh, mode="gspmd")
    f_frk = sharded_cqt_fn(cq, mesh, mode="gspmd", keep_sharded=True)
    got = call(f"3g j: frame-sharded CQT (mode gspmd), one clip of "
               f"{S12_CQT_SECONDS} s", lambda: f_fr(x1), {}, 1.0)
    check("gate 3g j frame-sharded CQT vs CQT.cqt (of the peak)",
          gate_err(got, cq.cqt(x1)), S12_CQT_TOL)
    del got
    hours = x1.numel() / SR / 3600.0
    pair("frame-sharded CQT", lambda: f_fr(x1), lambda: f_frk(x1), {}, 1.0,
         hours)
    s12["cqt_b1"] = (lambda: f_cq(x1), lambda: f_fr(x1),
                     lambda: cq.cqt(x1), hours)

    # --- the batch maps on 3g e's clips --------------------------------------
    xm, hp, yin = d["mir_x"], d["hp"], d["yin"]
    hours = xm.numel() / SR / 3600.0
    pair("HPSS.hpss through the batch map", lambda: d["f_hp"](xm),
         lambda f=sharded_batch_map_fn(hp.hpss, mesh, keep_sharded=True):
         f(xm), {"fft_pow2": S10_DATA, "fft_inv": S10_DATA,
                 "median_filter": S10_DATA}, 20.0, hours)
    pair("PitchYIN.pitch through the batch map", lambda: d["f_yin"](xm),
         lambda f=sharded_batch_map_fn(yin.pitch, mesh, keep_sharded=True):
         f(xm), {"fft_autocorr_yin": S10_DATA}, 4.0, hours)
    s12.update(ccwt=(lambda: f_cc(xl), lambda: f_cck(xl)),
               cst=(lambda: f_cs(xc), lambda: f_csk(xc)))
    return s12


def s12_peak(fn):
    """(peak device memory, its part above what was held before) in GB of
    one call of ``fn``, its result freed after."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del out
    return peak / 1e9, (peak - held) / 1e9


def phase4_slice12_timing(s12):
    phase("phase 4g j: slice 12 timing, default against kept in turns "
          "(default, kept, kept, default; CUDA events, median of 5 each)")

    def turns(a, b):
        a1 = cuda_ms(a, reps=5, warmup=1)
        b1, b2 = cuda_ms(b, reps=5, warmup=1), cuda_ms(b, reps=5, warmup=1)
        return (a1, cuda_ms(a, reps=5, warmup=1)), (b1, b2)
    for label, default, kept, hours in s12["pairs"]:
        (d1, d2), (k1, k2) = turns(default, kept)
        d_ms, k_ms = (d1 + d2) / 2, (k1 + k2) / 2
        rate = (f"; {hours / (d_ms / 1e3):.3f} and {hours / (k_ms / 1e3):.3f}"
                " audio-hours/s" if hours else "")
        print(f"  4g j {label}: default {d1:.3f}, {d2:.3f} ms; kept "
              f"{k1:.3f}, {k2:.3f} ms; kept / default {k_ms / d_ms:.3f}{rate}")
    for name in ("ccwt", "cst"):
        default, kept = s12[name]
        pd, ad = s12_peak(default)
        pk, ak = s12_peak(kept)
        print(f"  4g j {name} peak device memory: default {pd:.3f} GB "
              f"({ad:.3f} above the held), kept {pk:.3f} GB ({ak:.3f} above "
              f"the held); saved {pd - pk:.3f} GB")
    batch, frames, unsharded, hours = s12["cqt_b1"]
    (b1, b2), (f1, f2) = turns(batch, frames)
    u_ms = cuda_ms(unsharded, reps=5, warmup=1)
    f_ms = (f1 + f2) / 2
    print(f"  4g j CQT on one clip of {S12_CQT_SECONDS} s: batch form (one "
          f"shard works) {b1:.3f}, {b2:.3f} ms; frame form {f1:.3f}, "
          f"{f2:.3f} ms; unsharded {u_ms:.3f} ms; frame / batch "
          f"{2 * f_ms / (b1 + b2):.3f}; {hours / (f_ms / 1e3):.3f} "
          "audio-hours/s in the frame form")


def pair_rel(got, ref):
    """max error over the peak of (re, im) pairs (im may be None)."""
    e, pk = pair_err(got, ref)
    return e / pk


def merge_slice10(rows, launches, shapes):
    """The kernels line's rows gain the slice-10 paths' launches (the
    entries of a kernel of several entries their own) and their readings
    at one shard's shapes under ``shapes``."""
    extra = {"fused_mel_mfcc": ("fused_mel_mfcc",), "fft_pow2": ("fft_pow2",),
             "fft_inv": ("fft_inv",), "median_filter": ("median_filter",),
             "cwt_ifft_bank": ("cwt_ifft_bank",),
             "columnar_scatter": ("columnar_scatter",)}
    for row in rows:
        name = row["name"]
        if "entries" in row:
            for e in row["entries"]:
                e["launches"] += launches.get(e["entry"], 0)
            main = next(e for e in row["entries"] if e["entry"] == row["entry"])
            row["launches"] = (sum(e["launches"] for e in row["entries"])
                               if name == "fft_autocorr" else main["launches"])
        else:
            row["launches"] += sum(launches.get(k, 0)
                                   for k in extra.get(name, ()))
        if name in shapes:
            row.setdefault("shapes", []).extend(shapes[name])
    return rows


def merge_real_route(rows, launch_dicts):
    """The FFT rows gain ``real_route_launches``, ``row_route_launches``
    and ``cluster_route_launches``: the shares of their main-path launches
    that took the real-row route, the complex rows at 8192-16384 and the
    complex rows at 32768 (slices 7-10 run them; the mel+MFCC, MIR and
    wavelet paths transform at 2048 and 4096 only)."""
    for row in rows:
        if row["name"] in ("fft_pow2", "fft_inv"):
            for way, key in (("real-row", "real_route_launches"),
                             ("row", "row_route_launches"),
                             ("cluster", "cluster_route_launches")):
                row[key] = sum(d.get(f"{row['name']} {way} route", 0)
                               for d in launch_dicts)
    return rows


def main():
    if "--s10-worker" in sys.argv:     # one process of phase 3g h
        i = sys.argv.index("--s10-worker")
        s10_worker(int(sys.argv[i + 1]), int(sys.argv[i + 2]), sys.argv[i + 3])
        return
    upto = int(sys.argv[sys.argv.index("--upto") + 1]) if "--upto" in sys.argv else 4
    smi = phase0_identity()
    phase1_build()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    if upto < 2:
        return
    errs = phase2_kernels(gen)
    phase2_wavelet_kernels(gen, errs)
    phase2_slice7_kernels(gen, errs)
    phase2_slice8_kernels(gen)
    errs9 = phase2_slice9_kernels(gen)
    errs9.update({k: errs[k] for k in ("frames", "acf 16384", "acf 32768")})
    torch.cuda.empty_cache()
    if upto < 3:
        return
    plan, x, xs, mel_launches = phase3_mel_path(gen)
    mir = phase3_mir_path(gen, errs)
    if upto < 4:
        del plan, x, xs, mir
        phase3_wavelet_path(gen, errs)
        torch.cuda.empty_cache()
        phase3_slice7_paths(gen, errs)
        torch.cuda.empty_cache()
        phase3_slice8_paths(gen)
        torch.cuda.empty_cache()
        phase3_slice9_paths(gen)
        torch.cuda.empty_cache()
        slice10 = phase3_slice10_paths(gen)
        phase3_slice12_paths(slice10, gen)
        shutil.rmtree(slice10["tmp"], ignore_errors=True)
        return
    rows = phase4_timing(plan, x, xs, mel_launches, errs)
    del plan, x, xs
    rows += phase4_mir_timing(mir, mel_launches, errs)
    del mir
    torch.cuda.empty_cache()
    rows += phase4_wavelet_timing(phase3_wavelet_path(gen, errs), errs)
    torch.cuda.empty_cache()
    slice7 = phase3_slice7_paths(gen, errs)
    shapes = phase4_slice7_timing(slice7, errs)
    rows = merge_slice7(rows, slice7["launches"], shapes)
    later = [slice7["launches"]]
    del slice7
    torch.cuda.empty_cache()
    slice8 = phase3_slice8_paths(gen)
    rows = merge_slice8(rows, slice8["launches"], phase4_slice8_timing(slice8))
    later.append(slice8["launches"])
    del slice8
    torch.cuda.empty_cache()
    slice9 = phase3_slice9_paths(gen)
    rows = merge_slice9(rows, slice9["launches"],
                        phase4_slice9_timing(slice9, errs9))
    later.append(slice9["launches"])
    del slice9
    torch.cuda.empty_cache()
    slice10 = phase3_slice10_paths(gen)
    slice12 = phase3_slice12_paths(slice10, gen)
    shapes10 = phase4_slice10_timing(slice10)
    phase4_slice12_timing(slice12)
    del slice12
    rows = merge_slice10(rows, slice10["launches"], shapes10)
    later.append(slice10["launches"])
    del slice10
    rows = merge_real_route(rows, later)
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
