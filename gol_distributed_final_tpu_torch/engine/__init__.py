from .checkpoint import (
    CheckpointError,
    load_checkpoint,
    load_packed_checkpoint,
    load_resume_checkpoint,
    load_verified_checkpoint,
    save_checkpoint,
    save_packed_checkpoint,
)
from .engine import Engine, EngineConfig, RunResult, Snapshot

__all__ = [
    "CheckpointError",
    "Engine",
    "EngineConfig",
    "RunResult",
    "Snapshot",
    "load_checkpoint",
    "load_packed_checkpoint",
    "load_resume_checkpoint",
    "load_verified_checkpoint",
    "save_checkpoint",
    "save_packed_checkpoint",
]
