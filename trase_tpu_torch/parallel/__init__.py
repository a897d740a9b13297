"""Multi-device training over torch.distributed (trase_tpu/parallel):
the world and its collectives (world.py), the sharded render, steps,
densify and opacity reset (sharded.py), and the loop over them
(trainer.py: ShardedTrainer)."""
from .sharded import (  # noqa: F401
    interleave_rows,
    make_sharded_densify,
    make_sharded_feature_step,
    make_sharded_gaussian_step,
    shard_train_state,
    sharded_eval_render_fn,
    sharded_render_fn,
    unshard_train_state,
)
from .trainer import ShardedTrainer  # noqa: F401
from .world import World, close_world, init_world  # noqa: F401
