"""Serving subsystem of the port: the paged FP8 page pool, the continuous
scheduler and telemetry (``launch.serve.Engine`` executes the
scheduler's decisions)."""
from .page_pool import (
    PagePool,
    invariant_checks_enabled,
    kv_noise,
    pow2_page_scale,
    rescale_codes,
    token_row_codes,
    write_prefill_pages,
    write_token_page,
)
from .scheduler import (
    CANCELLED,
    FAILED,
    FINISHED,
    REJECTED,
    TERMINAL_STATES,
    TIMED_OUT,
    ContinuousScheduler,
    Request,
    ServeControl,
)
from .telemetry import METRIC_CATALOG, PHASES, Telemetry, default_registry

__all__ = [
    "CANCELLED",
    "ContinuousScheduler",
    "FAILED",
    "FINISHED",
    "METRIC_CATALOG",
    "PHASES",
    "PagePool",
    "REJECTED",
    "Request",
    "ServeControl",
    "TERMINAL_STATES",
    "TIMED_OUT",
    "Telemetry",
    "default_registry",
    "invariant_checks_enabled",
    "kv_noise",
    "pow2_page_scale",
    "rescale_codes",
    "token_row_codes",
    "write_prefill_pages",
    "write_token_page",
]
