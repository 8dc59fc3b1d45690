"""Gang helpers (the port's copy of ``free_port`` and ``rank_argv`` from
``repro.distributed.gang``): the campaign executor spawns one ``run
train`` subprocess per rank, each with ``--dist_rank i --coordinator
127.0.0.1:<port>`` appended.  Both stay free of torch: the executor's
scheduler process imports them."""
from __future__ import annotations

import socket
from typing import List


def free_port(host: str = "127.0.0.1") -> int:
    """An OS-assigned free TCP port (bind-to-0).  Racy by nature, but
    the coordinator binds immediately after."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def rank_argv(base_argv: List[str], rank: int, coordinator: str
              ) -> List[str]:
    """Append the per-rank distributed flags to a ``run train`` argv."""
    return list(base_argv) + [f"--dist_rank={rank}",
                              f"--coordinator={coordinator}"]
