"""The parameter-sharded layouts: the reference's rule tables
(:mod:`.rules`), the activation ctx (:mod:`.ctx`), the gang's ranks as a
named grid (:mod:`.grid`), FSDP storage with per-layer gathers
(:mod:`.fsdp`), tensor parallelism over the model axis (:mod:`.tp`) and
sequence parallelism over it (:mod:`.sp`)."""
from repro_torch.sharding import rules
from repro_torch.sharding.ctx import (ShardCtx, current_ctx, set_ctx,
                                      use_ctx)

__all__ = ["ShardCtx", "current_ctx", "set_ctx", "use_ctx", "rules"]
