from edl_tpu_torch.cluster.job_env import JobEnv, WorkerEnv

__all__ = ["JobEnv", "WorkerEnv"]
