"""The reference's ctx readers on a real host mesh of four CPU devices
(``{data: 2, model: 2}``): ``moe_apply`` (grouped dispatch) and
``ssm_apply`` (the sequence-parallel scan under ``fsdp_sp``), jitted under
``ShardCtx(mesh, logical_axes(mesh, layout))`` for each layout of
``LAYOUTS``, on the inputs and weights in ``WORKDIR/inputs.npz``.
Writes ``WORKDIR/ref.npz``.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/jax_sharded_mixers.py WORKDIR
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_reduced
from repro.models import moe as JMOE
from repro.models import ssm as JS
from repro.sharding import ShardCtx, rules
from repro.sharding.ctx import use_ctx

LAYOUTS = ("fsdp_tp", "fsdp_sp")


def unflat(inp, prefix):
    out = {}
    for k, v in inp.items():
        if k.startswith(prefix):
            *parents, leaf = k[len(prefix):].split("/")
            d = out
            for p in parents:
                d = d.setdefault(p, {})
            d[leaf] = jnp.asarray(v)
    return out


def main(work: Path) -> None:
    inp = dict(np.load(work / "inputs.npz"))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                             ("data", "model"))
    moe_cfg = get_reduced("qwen3-moe-30b-a3b")
    ssm_cfg = get_reduced("mamba2-2.7b").ssm
    moe_p, ssm_p = unflat(inp, "moe/"), unflat(inp, "ssm/")
    out = {}
    for layout in LAYOUTS:
        with use_ctx(ShardCtx(mesh, rules.logical_axes(mesh, layout))):
            for masked in (False, True):
                mask = jnp.asarray(inp["mask"]) if masked else None
                y, aux = jax.jit(lambda p, x, m: JMOE.moe_apply(
                    p, x, moe_cfg.moe, moe_cfg.act, token_mask=m))(
                    moe_p, jnp.asarray(inp["moe_x"]), mask)
                out[f"{layout}/moe/{masked}/y"] = np.asarray(y)
                out[f"{layout}/moe/{masked}/aux"] = np.asarray(aux)
            y, st = jax.jit(lambda p, x: JS.ssm_apply(
                p, x, ssm_cfg, return_state=True))(
                ssm_p, jnp.asarray(inp["ssm_x"]))
            out[f"{layout}/ssm/y"] = np.asarray(y)
            out[f"{layout}/ssm/h"] = np.asarray(st["h"])
    np.savez(work / "ref.npz", **out)


if __name__ == "__main__":
    main(Path(sys.argv[1]))
