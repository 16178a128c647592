"""Config system: YAML + parent inheritance + dotted CLI overrides."""

from gdb_nerf_tpu_torch.config.config import (
    DEFAULT_CFG,
    decode_value,
    dotdictify,
    load_cfg,
    make_cfg,
    make_parser,
    merge_dicts,
)
