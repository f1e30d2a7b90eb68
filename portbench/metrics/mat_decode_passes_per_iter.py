"""The program's `mat_decode_passes` counter an iteration: each pass of
MAT's decoder, M a rollout step and one a PPO minibatch (T·M + ppo_epoch
· num_mini_batch)."""
from portbench.metrics import _program


def read(ctx):
    return _program.counter(ctx, "mat_decode_passes")
