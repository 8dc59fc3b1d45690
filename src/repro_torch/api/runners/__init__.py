# Built-in runner adapters, one module per kind.  Imported lazily by the
# registry so `import repro_torch.api` stays torch-free; importing this
# package eagerly registers everything (useful for tests / introspection).
from repro_torch.api.runners import (dryrun, perfprobe, serve,  # noqa: F401
                                     simulate, train)
