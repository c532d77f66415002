"""Training of the port, the twin of ``lambdipy_tpu/train/``: the train
step with JAX's optimizer stack (``step.py``), the port's checkpoints
(``checkpoint.py``) and the resumable ``Trainer`` (``loop.py``), on one
device or as one rank of a ``dp`` mesh (FSDP over ``dp``)."""

from lambdipy_tpu_torch.train.step import (TrainState, make_optimizer,
                                           make_train_step)

__all__ = ["TrainState", "make_optimizer", "make_train_step"]
