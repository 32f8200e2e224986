"""Batch runner: files -> native loader -> sharded spectrogram.

Counterpart of ``audioflux_tpu/parallel/runner.py`` (the benchmark's
config 5 shape): a batch of WAV files is decoded on the host by the native
C++ loader (``io.native.load_batch``, several threads), split over the
mesh (batch over ``data``, samples over ``time``) and pushed through
``sharded_spectrogram_fn``.

Multi-process: after ``parallel.distributed.initialize`` each process
feeds its own rows (``global_from_local``); one process behaves as before.

Long jobs checkpoint and restart: ``run_files_resumable`` keeps an
append-only manifest of finished files next to the saved outputs, fsyncs
it after every chunk, and skips finished work on restart, so that a rerun
after a kill at any point completes each file exactly once.
"""

from __future__ import annotations

import json
import os

import numpy as np

from audioflux_torch.observe import metrics
from audioflux_torch.parallel.distributed import global_from_local
from audioflux_torch.parallel.mesh import Mesh
from audioflux_torch.parallel.sharded import sharded_spectrogram_fn

__all__ = ["BatchRunner"]


class BatchRunner:
    """Run a spectrogram plan over batches of files on a device mesh."""

    def __init__(self, plan, mesh: Mesh, clip_length: int,
                 with_xxcc: int = 0, loader_threads: int = 4):
        time_shards = mesh.shape["time"]
        if clip_length % (time_shards * plan.slide_length) != 0:
            raise ValueError(
                "clip_length must be divisible by time_shards * slide")
        self.plan = plan
        self.mesh = mesh
        self.clip_length = clip_length
        self.loader_threads = loader_threads
        self._fn = sharded_spectrogram_fn(plan, mesh, with_xxcc=with_xxcc)
        self._spec = ("data", "time")

    def run_files(self, paths):
        """Decode and process a list of WAV paths (mono, truncated or
        zero-padded to ``clip_length``); the batch must divide the 'data'
        axis.  Returns (output, number of files decoded)."""
        from audioflux_torch.io import native
        with metrics.timer("af.load_batch"):
            batch, good = native.load_batch(paths, self.clip_length,
                                            self.loader_threads)
        return self.run_array(batch), good

    def run_array(self, batch):
        """(B, clip_length) float32 -> the sharded pipeline's output, on
        the mesh's first device.  Under several processes ``batch`` is this
        process's rows of the global batch."""
        with metrics.timer("af.run_array"):
            x = global_from_local(batch, self.mesh, self._spec)
            out = self._fn(x)
            metrics.count("af.clips", x.shape[0])
            return out

    def run_files_resumable(self, paths, out_dir: str,
                            chunk_size: int | None = None,
                            max_chunks: int | None = None):
        """Process ``paths`` in chunks, saving one ``.npy`` a file (the
        spectrogram) and a manifest.

        The manifest (``manifest.jsonl`` in ``out_dir``) records each
        finished file; a restart with the same arguments skips the files
        in it, so every file is processed exactly once across any number
        of kills and restarts.  Returns (files done by this call, files
        skipped).  ``max_chunks`` bounds the chunks of one call (the tests
        simulate a kill with it)."""
        from audioflux_torch.io import native

        os.makedirs(out_dir, exist_ok=True)
        manifest = os.path.join(out_dir, "manifest.jsonl")
        done = set()
        if os.path.exists(manifest):
            with open(manifest) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        done.add(json.loads(line)["path"])
        todo = [p for p in paths if p not in done]
        if chunk_size is None:
            chunk_size = max(1, int(self.mesh.shape["data"]))
        n_new = 0
        chunks = 0
        for i in range(0, len(todo), chunk_size):
            if max_chunks is not None and chunks >= max_chunks:
                break
            chunk = todo[i:i + chunk_size]
            pad = chunk + [chunk[-1]] * (chunk_size - len(chunk))
            batch, _ = native.load_batch(pad, self.clip_length,
                                         self.loader_threads)
            out = self.run_array(batch)
            spec = out[0] if isinstance(out, tuple) else out
            spec = spec.detach().cpu().numpy()
            with open(manifest, "a") as f:
                for j, p in enumerate(chunk):
                    base = os.path.splitext(os.path.basename(p))[0]
                    np.save(os.path.join(out_dir, base + ".npy"), spec[j])
                    f.write(json.dumps({"path": p}) + "\n")
                f.flush()
                os.fsync(f.fileno())
            n_new += len(chunk)
            chunks += 1
        return n_new, len(paths) - len(todo)
