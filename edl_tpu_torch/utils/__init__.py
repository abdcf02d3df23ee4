from edl_tpu_torch.utils.device import resolve_device
from edl_tpu_torch.utils.log import get_logger
from edl_tpu_torch.utils.net import find_free_ports, get_host_ip, is_server_alive

__all__ = [
    "resolve_device", "get_logger", "find_free_ports", "get_host_ip",
    "is_server_alive",
]
