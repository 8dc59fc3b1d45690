"""The port's model inputs (``repro_torch.data.inputs``) against the JAX
package's (``repro.data.inputs``): the specs' shapes and dtypes, and the
batches bit for bit, for the audio (hubert-xlarge), vlm
(llava-next-mistral-7b) and text families, with f32 and bf16 parameters.
The random draws come from one numpy generator in the specs' order, so
equal seeds give equal batches; a bf16 field is an f32 draw rounded to
nearest even in both packages.  Also the two full configs' parameter
counts."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.data import inputs as JI  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.data import inputs as TI  # noqa: E402

ARCHS = ["hubert-xlarge", "llava-next-mistral-7b", "granite-3-2b"]
DTYPES = ["float32", "bfloat16"]
# (batch, seq): a vlm takes min(frontend_tokens, seq // 4) patches, so
# seq 8 gives 2 of the reduced 16 and seq 128 all 16
SIZES = [(2, 8), (3, 32), (1, 128)]


def _cfgs(arch, dtype):
    return (dataclasses.replace(jax_reduced(arch), param_dtype=dtype),
            dataclasses.replace(get_reduced(arch), param_dtype=dtype))


def _bits(x):
    """An array's bytes as numpy, bf16 as its 16-bit pattern."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_batches_equal(tb, jb):
    assert list(tb) == list(jb)             # the same fields, drawn in order
    for name in jb:
        assert str(tb[name].dtype) == f"torch.{jb[name].dtype}", name
        assert tuple(tb[name].shape) == jb[name].shape, name
        np.testing.assert_array_equal(_bits(tb[name]), _bits(jb[name]),
                                      err_msg=name)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_the_reference(arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype)
    for b, s in SIZES:
        js, ts = JI.input_specs(jcfg, b, s), TI.input_specs(tcfg, b, s)
        assert list(ts) == list(js)
        for name, spec in js.items():
            assert ts[name].device.type == "meta"
            assert tuple(ts[name].shape) == spec.shape, name
            assert str(ts[name].dtype) == f"torch.{spec.dtype}", name
    jd, td = JI.decode_specs(jcfg, 3), TI.decode_specs(tcfg, 3)
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in td.items()} == {
        k: (v.shape, f"torch.{v.dtype}") for k, v in jd.items()}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_make_batch_is_the_reference_bitwise(arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype)
    for seed, (b, s) in enumerate(SIZES):
        _assert_batches_equal(TI.make_batch(tcfg, b, s, seed, device="cpu"),
                              JI.make_batch(jcfg, b, s, seed))
    if tcfg.family == "vlm":
        P = TI.vlm_patches(tcfg, 32)
        assert P == min(tcfg.frontend_tokens, 8)
        batch = TI.make_batch(tcfg, 2, 32, device="cpu")
        assert batch["patches"].shape[1] + batch["tokens"].shape[1] == 32


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ["hubert-xlarge", "llava-next-mistral-7b"])
def test_seekable_batches_and_cursor_match_the_reference(arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype)
    j = JI.SeekableSyntheticBatches(jcfg, 2, 16, seed=5)
    t = TI.SeekableSyntheticBatches(tcfg, 2, 16, seed=5, device="cpu")
    for _ in range(3):
        _assert_batches_equal(t.next_batch(), j.next_batch())
    assert t.cursor() == j.cursor() == {"step": 3}
    # a fresh stream sought to the cursor resumes the same sequence, and
    # a seek back repeats an earlier batch
    fresh = TI.SeekableSyntheticBatches(tcfg, 2, 16, seed=5, device="cpu")
    fresh.seek(t.cursor())
    _assert_batches_equal(fresh.next_batch(), j.next_batch())
    fresh.seek({"step": 1})
    j.seek({"step": 1})
    _assert_batches_equal(next(iter(fresh)), next(iter(j)))
    assert fresh.cursor() == j.cursor() == {"step": 2}


def test_make_decode_batch_matches_the_reference():
    jcfg, tcfg = _cfgs("llava-next-mistral-7b", "float32")
    jb = JI.make_decode_batch(jcfg, 4, 17, seed=3)
    tb = TI.make_decode_batch(tcfg, 4, 17, seed=3, device="cpu")
    for name in jb:
        assert tb[name].dtype == torch.int32
        np.testing.assert_array_equal(tb[name].numpy(), np.asarray(jb[name]))


@pytest.mark.parametrize("arch,count", [("hubert-xlarge", 945_256_960),
                                        ("llava-next-mistral-7b",
                                         7_241_732_096)])
def test_full_configs_match_the_reference(arch, count):
    full, jfull = get_config(arch), jax_config(arch)
    assert full.param_count() == jfull.param_count() == count
    for t, j in ((full, jfull), (get_reduced(arch), jax_reduced(arch))):
        a, b = dataclasses.asdict(t), dataclasses.asdict(j)
        for d in (a, b):
            d.pop("attention_backend")
            d.pop("mixer_backend")
        assert a == b
    assert jnp.dtype(full.param_dtype) == jnp.bfloat16
