"""What the A/B tools share: another tree's port imported beside this one,
the card's name and power limit, and the ptxas lines of a build log."""

from __future__ import annotations

import importlib
import subprocess
import sys
from pathlib import Path

PACKAGE = "gdb_nerf_tpu_torch"


def import_from_tree(root: Path, module: str):
    """The module ``gdb_nerf_tpu_torch.<module>`` of the port under ``root``
    (another tree's ``gdb_nerf_tpu_torch``), imported beside this tree's:
    its modules leave ``sys.modules`` again, and it keeps its own ``build``
    paths."""
    ours = {k: sys.modules.pop(k) for k in list(sys.modules) if k.split(".")[0] == PACKAGE}
    sys.path.insert(0, str(root))
    try:
        return importlib.import_module(f"{PACKAGE}.{module}")
    finally:
        sys.path.remove(str(root))
        for k in [k for k in sys.modules if k.split(".")[0] == PACKAGE]:
            del sys.modules[k]
        sys.modules.update(ours)


def card_name() -> str:
    """``name, power limit`` of the card, as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def ptxas_lines(log: str) -> list[str]:
    return [line.strip() for line in log.splitlines()
            if any(s in line for s in ("entry function", "registers", "spill", "smem"))]
