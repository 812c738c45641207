"""Training substrate (``repro.train``): optimizer, loop, checkpointing,
fault tolerance, gradient telemetry."""
from .checkpoint import Checkpointer
from .fault_tolerance import HeartbeatMonitor, StepWatchdog, run_with_recovery
from .loop import make_train_step, train_loop, value_and_grad
from .optimizer import AdamWState, Optimizer, adamw, global_norm, warmup_cosine
from .telemetry import (GradSketch, grad_cosine, grad_inner_product,
                        gradient_noise_scale, sketch_grads)

__all__ = [
    "AdamWState", "Optimizer", "adamw", "global_norm", "warmup_cosine",
    "make_train_step", "train_loop", "value_and_grad", "Checkpointer",
    "HeartbeatMonitor", "StepWatchdog", "run_with_recovery", "GradSketch",
    "grad_cosine", "grad_inner_product", "gradient_noise_scale",
    "sketch_grads",
]
