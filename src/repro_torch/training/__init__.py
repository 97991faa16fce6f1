"""Training substrate: optimizer, synthetic task, train loop, checkpoints
(port of ``repro.training``)."""
from .optimizer import AdamWConfig, adamw_init, adamw_update, cosine_lr  # noqa: F401
from .task import ArithmeticTask  # noqa: F401
from .train import TrainConfig, prm_loss_fn, train_lm, train_prm  # noqa: F401
