from admmnet_tpu_torch.peaks.spectrum import spectrum_at, spectrum_grid
from admmnet_tpu_torch.peaks.search import PeakResult, find_peaks
from admmnet_tpu_torch.peaks.metrics import match_peaks, phi_nmse, scale_invariant_nmse

__all__ = [
    "spectrum_at",
    "spectrum_grid",
    "PeakResult",
    "find_peaks",
    "match_peaks",
    "phi_nmse",
    "scale_invariant_nmse",
]
