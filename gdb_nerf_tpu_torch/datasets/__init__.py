"""Host-side data pipeline: dataset readers, samplers, loader."""

from gdb_nerf_tpu_torch.datasets.loader import make_data_loader
