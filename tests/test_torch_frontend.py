"""The port's front-end (plain version, which CPU tensors take) against
the Pallas front-end mccortex_tpu.ops.pallas.frontend.records_fused in
interpret mode and against mccortex_tpu.graph.build.reads_to_records.
Integer outputs: exact equality, no tolerance."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mccortex_tpu.graph import build as jb
from mccortex_tpu.ops.pallas import frontend as jfe
from mccortex_tpu_torch.graph import build as tb
from mccortex_tpu_torch.ops.kernels import frontend as tfe


def _bases(seed, B, L):
    rng = np.random.default_rng(seed)
    bases = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    bases[rng.random((B, L)) < 0.03] = 4               # N bases
    bases[1, L // 2:] = 4                               # a short read
    return bases


@pytest.mark.parametrize("k,L", [(11, 100), (31, 100), (33, 150),
                                 (63, 150), (31, 20)])
def test_records_match_pallas_kernel(k, L):
    bases = _bases(900 + k + L, 24, L)
    want = jfe.records_fused(jnp.asarray(bases), k, interpret=True,
                             with_valid=False)
    got = tfe.records_fused(torch.from_numpy(bases), k)
    assert len(got) == len(want) == (3 if k <= 31 else 5)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and tuple(g.shape) == bases.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("k", [11, 31, 33, 63, 95])
def test_reads_to_records_matches_jax(k):
    bases = _bases(1000 + k, 12, 130)
    jkeys, jeb, jv = jb.reads_to_records(jnp.asarray(bases), k)
    tkeys, teb, tv = tb.reads_to_records(torch.from_numpy(bases), k)
    np.testing.assert_array_equal(tkeys.numpy().view(np.uint64),
                                  np.asarray(jkeys))
    np.testing.assert_array_equal(teb.numpy(), np.asarray(jeb))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_records_rejects_unsupported_input():
    bases = torch.zeros((2, 40), dtype=torch.uint8)
    with pytest.raises(ValueError):
        tfe.records_fused(bases, 65)
    with pytest.raises(ValueError):
        tfe.records_fused(bases.to(torch.int32), 31)
    with pytest.raises(ValueError):
        tfe.records_fused(bases.to("meta"), 31)
