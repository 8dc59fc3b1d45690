"""The flash-attention forward's route table on the CPU: which (dtype,
head_dim) pairs the wrapper sends to the tensor-core kernel and which to the
CUDA-core one, that ``flash_fwd.cu`` dispatches on the same table, and that
the CPU path launches nothing.  The kernels themselves run only on the card
(``tests/test_torch_cuda.py``)."""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa  # noqa: E402

HEAD_DIMS = list(range(16, 257, 16))


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_bf16_takes_the_tensor_cores_only_at_64_and_128(hd):
    want = "tensor_core" if hd in (64, 128) else "cuda_core"
    assert fa.route(torch.bfloat16, hd) == want


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_f32_stays_on_the_cuda_cores(hd):
    # TF32 tensor cores would break the f32 tolerance (2e-5)
    assert fa.route(torch.float32, hd) == "cuda_core"


def test_the_models_on_a_main_path_take_the_tensor_cores():
    from repro_torch.configs import get_config
    for arch in ("granite-3-2b", "stablelm-1.6b"):
        cfg = get_config(arch)
        assert cfg.param_dtype == "bfloat16"
        assert fa.route(torch.bfloat16, cfg.head_dim) == "tensor_core"


def test_the_cuda_source_dispatches_on_the_same_table():
    src = Path(fa.SOURCE).read_text()
    body = re.search(r"int route_of\(int dtype, int hd\) \{\s*return ([^;]*);",
                     src)
    assert body, "route_of not found in flash_fwd.cu"
    expr = body.group(1)
    assert "dtype == 1" in expr      # bf16 in flash_fwd's dtype codes
    assert sorted(int(d) for d in re.findall(r"hd == (\d+)", expr)) == \
        sorted(hd for dt, hd in fa.TENSOR_CORE)
    assert {dt for dt, _ in fa.TENSOR_CORE} == {torch.bfloat16}
    assert fa._DTYPES[torch.bfloat16] == 1


def test_counters_start_per_route():
    by_route = fa.flash_attention_fwd_kernel.launches_by_route
    assert set(by_route) == set(fa.ROUTES) == {"tensor_core", "cuda_core"}


def test_the_cpu_path_launches_no_kernel():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (1, 40, 4, 64), dtype=np.float32)).to(torch.bfloat16)
        for _ in range(3))
    n0 = fa.flash_attention_fwd_kernel.launches
    by0 = dict(fa.flash_attention_fwd_kernel.launches_by_route)
    out = flash_attention(q, k, v, causal=True)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert fa.flash_attention_fwd_kernel.launches == n0
    assert fa.flash_attention_fwd_kernel.launches_by_route == by0
