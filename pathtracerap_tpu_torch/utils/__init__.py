from .checkpoint import RenderCheckpoint, save_checkpoint, load_checkpoint
from .failure import (
    FaultInjector,
    Heartbeat,
    InjectedFault,
    liveness_probe,
    run_with_recovery,
)
from .metrics import RenderMetrics, MetricsLogger
from .profiling import profile_trace, annotate, sync_device

__all__ = [
    "RenderCheckpoint",
    "save_checkpoint",
    "load_checkpoint",
    "FaultInjector",
    "Heartbeat",
    "InjectedFault",
    "liveness_probe",
    "run_with_recovery",
    "RenderMetrics",
    "MetricsLogger",
    "profile_trace",
    "annotate",
    "sync_device",
]
