from audioflux_torch.classic.nmf import NMF, nmf  # noqa: F401
from audioflux_torch.classic.hmm import HMM  # noqa: F401
from audioflux_torch.classic.viterbi import viterbi  # noqa: F401
