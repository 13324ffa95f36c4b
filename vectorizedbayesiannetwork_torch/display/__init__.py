"""Optional plotting: matplotlib is imported only when a figure is drawn."""
from .figures import plot_cpd_fit, plot_inference_posterior, plot_sampling_outcome
from .plots import plots_enabled
