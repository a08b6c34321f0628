from .discovery import available_devices, default_device, device_platform, get_device
from .memory import free_memory_bytes, total_memory_bytes

__all__ = [
    "available_devices",
    "get_device",
    "device_platform",
    "default_device",
    "free_memory_bytes",
    "total_memory_bytes",
]
