"""The parameter-sharded layouts: the reference's rule tables
(:mod:`.rules`), the activation ctx (:mod:`.ctx`), the gang's ranks as a
named grid (:mod:`.grid`) and FSDP storage with per-layer gathers
(:mod:`.fsdp`)."""
from repro_torch.sharding import rules
from repro_torch.sharding.ctx import (ShardCtx, current_ctx, set_ctx,
                                      use_ctx)

__all__ = ["ShardCtx", "current_ctx", "set_ctx", "use_ctx", "rules"]
