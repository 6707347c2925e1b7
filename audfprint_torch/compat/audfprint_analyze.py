"""Reference audfprint_analyze.py surface."""

from audfprint_torch.models.analyzer import Analyzer  # noqa: F401
from audfprint_torch.oracle.analyze import (  # noqa: F401
    find_peaks,
    hashes2landmarks,
    landmarks2hashes,
    locmax,
    peaks2landmarks,
    spreadpeaks,
    spreadpeaksinvector,
)
from audfprint_torch.params import (  # noqa: F401
    DENSITY,
    F_SD,
    MAX_PAIRS_PER_PEAK,
    MAX_PKS_PER_FRAME,
    N_FFT,
    N_HOP,
    OVERSAMP,
    PRECOMPEXT,
    PRECOMPPKEXT,
    TARGET_SR,
)
from audfprint_torch.utils.formats import (  # noqa: F401
    hashes_load,
    hashes_save,
    peaks_load,
    peaks_save,
)


def glob2hashtable(pattern, ht=None, device=None):
    """Files matching `pattern` fingerprinted by a default Analyzer on
    `device` (None: CUDA) and stored into `ht` (None: a new HashTable)."""
    return Analyzer(device=device).glob2hashtable(pattern, ht)
