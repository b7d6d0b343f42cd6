"""gin-tu [gnn] n_layers=5 d_hidden=64 aggregator=sum eps=learnable
[arXiv:1810.00826; paper]. Its four input shapes are
``configs.gnn_family.GNN_SHAPES``."""
from repro_torch._device import DeviceLike
from repro_torch.models.gnn import GINConfig

CONFIG = GINConfig(name="gin-tu", n_layers=5, d_hidden=64)


def smoke(device: DeviceLike = None):
    """gin-tu's smoke step: ``gnn_family.smoke()``."""
    from repro_torch.configs import gnn_family   # it imports CONFIG
    return gnn_family.smoke(device)
