"""Training on the card (reference: mettagrid_tpu/parallel/).

``make_train_step`` runs the env step and the actor-critic update on one
device. The reference's mesh helpers (``make_mesh``, ``shard_batch``,
``replicate``) and its sharded step wait for the multi-device slice.
"""

from mettagrid_tpu_torch.parallel.train import TrainState, adam, make_train_step, trainable_parameters

__all__ = ["TrainState", "adam", "make_train_step", "trainable_parameters"]
