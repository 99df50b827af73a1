from .checkpoint import (
    export_ply,
    import_ply,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from .logging import MetricLogger, StageTimer
from .resilience import is_transient, run_resilient

__all__ = [
    "MetricLogger",
    "StageTimer",
    "export_ply",
    "import_ply",
    "is_transient",
    "latest_step",
    "run_resilient",
    "restore_checkpoint",
    "save_checkpoint",
]
