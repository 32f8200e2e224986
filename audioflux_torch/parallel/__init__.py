"""The parallel family: a device mesh, sharded transforms, a pipeline, a
batch runner and multi-process start-up, run by one controller that
walks the mesh's shards (see ``parallel/sharded.py``).  A sharded
function assembles its result on the mesh's first device, or, with
``keep_sharded=True``, returns a :class:`ShardedTensor` whose parts stay
on the devices that computed them."""

from audioflux_torch.parallel.mesh import Mesh, make_mesh
from audioflux_torch.parallel._shard import Shard, ShardedTensor
from audioflux_torch.parallel.sharded import (
    sharded_spectrogram_fn, sharded_stft_fn, sharded_istft_fn,
)
from audioflux_torch.parallel.sharded_full import (
    sharded_cwt_fn, sharded_pwt_fn, sharded_synsq_fn, sharded_wsst_fn,
    sharded_st_fn,
    sharded_fst_fn, sharded_nsgt_fn, sharded_cqt_fn, sharded_ccwt_fn,
    sharded_cst_fn, sharded_batch_fn, sharded_batch_map_fn,
)
from audioflux_torch.parallel.features import sharded_spectral_stats_fn
from audioflux_torch.parallel.runner import BatchRunner
from audioflux_torch.parallel.pipeline import pipeline_chain_fn
from audioflux_torch.parallel import distributed
