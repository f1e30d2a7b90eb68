from onpolicy_torch.envs.mpe.env import MPEEnv, MPEVecEnv, make_vec_env  # noqa: F401
