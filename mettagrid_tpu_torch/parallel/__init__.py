"""Training on the card, on one device or data-parallel over a mesh
(reference: mettagrid_tpu/parallel/).

``make_mesh`` builds a ("data", "model") mesh over a torch.distributed
process group; ``shard_batch`` gives each rank its rows of the env batch,
``replicate`` broadcasts the learner and ``gather_batch`` collects the rows
back. ``make_train_step`` runs the env step and the actor-critic update on
one device, or, with ``mesh=``, on each rank's own envs with the gradients
averaged over "data" in one all-reduce a step. The env step needs no
communication. ``dryrun.py`` and ``rig.py`` are the twins of the
reference's multichip dryrun and two-process rig.
"""

from mettagrid_tpu_torch.parallel.mesh import gather_batch, make_mesh, replicate, shard_batch
from mettagrid_tpu_torch.parallel.train import TrainState, adam, make_train_step, trainable_parameters

__all__ = ["make_mesh", "shard_batch", "replicate", "gather_batch", "TrainState", "adam", "make_train_step",
           "trainable_parameters"]
