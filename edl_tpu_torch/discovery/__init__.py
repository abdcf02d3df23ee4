from edl_tpu_torch.discovery.consistent_hash import ConsistentHash
from edl_tpu_torch.discovery.registry import Registry, ServerMeta, ServiceWatch

__all__ = ["ConsistentHash", "Registry", "ServerMeta", "ServiceWatch"]
