from ..core.utils import (
    as_array,
    broadcast_samples,
    concat_parents,
    df_to_array_dict,
    ensure_2d,
    flatten_samples,
    infer_batch_size,
    unflatten_samples,
)
from .device_logging import get_device_string, log_device
from .interventions import (
    effective_parents,
    get_fixed_value,
    is_intervened,
    is_observed,
)
from .profiling import StageTimer, annotate, timed_call, trace
