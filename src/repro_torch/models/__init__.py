"""Dense transformer model of the port (PyTorch counterparts of
``repro.models``)."""

from repro_torch.models.model import Model

__all__ = ["Model"]
