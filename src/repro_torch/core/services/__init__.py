"""Resource-level services (paper §4.3.2): message, object store, file."""
from repro_torch.core.services.object_store import ObjectStore
from repro_torch.core.services.file_service import FileService

__all__ = ["ObjectStore", "FileService"]
