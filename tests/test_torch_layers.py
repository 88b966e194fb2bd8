"""The port's layers against ``repro.models.layers`` on shared numpy
inputs, in f32. Tolerance 1e-5 relative to 1: the same f32 formulas with
reductions and transcendental functions from another library."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import layers as J  # noqa: E402
from repro_torch.models import layers as T  # noqa: E402

RNG = np.random.default_rng(0)
X = RNG.standard_normal((2, 5, 3, 16)).astype(np.float32) * 3
SCALE = RNG.standard_normal((16,)).astype(np.float32) * 0.1
W = {k: RNG.standard_normal(s).astype(np.float32) * 0.2
     for k, s in (("w_gate", (16, 24)), ("w_up", (16, 24)),
                  ("w_down", (24, 16)))}
TABLE = RNG.standard_normal((40, 16)).astype(np.float32)
TOKENS = RNG.integers(0, 40, (2, 7)).astype(np.int32)
POS = np.broadcast_to(np.arange(5, dtype=np.int32) * 37, (2, 5)).copy()


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


CASES = {
    "rmsnorm": (lambda: T.rmsnorm({"scale": torch.from_numpy(SCALE)},
                                  torch.from_numpy(X), 1e-6),
                lambda: J.rmsnorm({"scale": jnp.asarray(SCALE)},
                                  jnp.asarray(X), 1e-6)),
    "norm_only": (lambda: T.norm_only(torch.from_numpy(X), 1e-6),
                  lambda: J.norm_only(jnp.asarray(X), 1e-6)),
    "swiglu": (lambda: T.swiglu(_t(W), torch.from_numpy(X[:, :, 0])),
               lambda: J.swiglu(_j(W), jnp.asarray(X[:, :, 0]))),
    "embed": (lambda: T.embed({"table": torch.from_numpy(TABLE)},
                              torch.from_numpy(TOKENS)),
              lambda: J.embed({"table": jnp.asarray(TABLE)},
                              jnp.asarray(TOKENS))),
    "unembed": (lambda: T.unembed(torch.from_numpy(TABLE),
                                  torch.from_numpy(X[:, :, 0])),
                lambda: J.unembed(jnp.asarray(TABLE), jnp.asarray(X[:, :, 0]))),
    "rope_heads": (lambda: T.rope(torch.from_numpy(X), torch.from_numpy(POS),
                                  10000.0),
                   lambda: J.rope(jnp.asarray(X), jnp.asarray(POS), 10000.0)),
    "rope_no_heads": (lambda: T.rope(torch.from_numpy(X[:, :, 0]),
                                     torch.from_numpy(POS), 500.0),
                      lambda: J.rope(jnp.asarray(X[:, :, 0]),
                                     jnp.asarray(POS), 500.0)),
    "softcap": (lambda: T.softcap(torch.from_numpy(X), 2.5),
                lambda: J.softcap(jnp.asarray(X), 2.5)),
    "softcap_off": (lambda: T.softcap(torch.from_numpy(X), 0.0),
                    lambda: J.softcap(jnp.asarray(X), 0.0)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_matches_repro(name):
    ours, theirs = (f() for f in CASES[name])
    theirs = np.asarray(theirs)
    assert tuple(ours.shape) == theirs.shape
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-5, atol=1e-5)


def test_bf16_rmsnorm_rounds_like_repro():
    """bf16 in, bf16 out, f32 inside: equal up to one bf16 ulp."""
    xb = torch.from_numpy(X).to(torch.bfloat16)
    ours = T.rmsnorm({"scale": torch.from_numpy(SCALE)}, xb, 1e-6)
    theirs = J.rmsnorm({"scale": jnp.asarray(SCALE)},
                       jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
                       1e-6)
    assert ours.dtype == torch.bfloat16
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(theirs.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)
