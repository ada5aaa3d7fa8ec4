"""The ReDas GEMM wrapper of the port on the CPU: its plain version
against the JAX Pallas kernel (interpret mode), the CPU path of the
`hopper` wrapper, and the wrapper's input checks.

The CUDA kernel itself runs only on the card: `chip_smoke.py` holds it
against the plain version there at every main-path shape.  Tolerance
rtol 2e-5, atol 2e-4, as tests/test_kernels.py uses for the f32 kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine.backends import pallas_gemm
from repro_torch.kernels import redas_gemm

SHAPES = [(40, 96, 200), (1, 160, 136), (257, 64, 8)]
TILE = dict(zip(("bm", "bk", "bn"), redas_gemm.TILES[0]))


def _operands(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(m, k)).astype(np.float32),
            rng.normal(size=(k, n)).astype(np.float32))


@pytest.mark.parametrize("dataflow", redas_gemm.DATAFLOWS)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_matches_pallas_kernel(dataflow, shape):
    a, b = _operands(*shape)
    want = pallas_gemm(jnp.asarray(a), jnp.asarray(b), dataflow=dataflow,
                       interpret=True)
    got = redas_gemm.gemm_reference(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("dataflow", redas_gemm.DATAFLOWS)
def test_cpu_tensors_take_plain_version_without_counting(dataflow):
    a, b = (torch.from_numpy(x) for x in _operands(40, 96, 200, seed=1))
    redas_gemm.reset_launches()
    got = redas_gemm.gemm(a, b, dataflow=dataflow, **TILE)
    torch.testing.assert_close(got, redas_gemm.gemm_reference(a, b),
                               rtol=0, atol=0)
    assert redas_gemm.launches == dict.fromkeys(redas_gemm.DATAFLOWS, 0)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    a, b = (torch.from_numpy(x) for x in _operands(32, 64, 48))
    with pytest.raises(ValueError, match="menu"):
        redas_gemm.gemm(a, b, bm=8, bk=128, bn=128)
    with pytest.raises(ValueError, match="contiguous"):
        redas_gemm.gemm(a, b.t().contiguous().t(), **TILE)
    with pytest.raises(ValueError, match="2-D"):
        redas_gemm.gemm(a[None], b, **TILE)
    with pytest.raises(ValueError, match="dataflow"):
        redas_gemm.gemm(a, b, dataflow="xs", **TILE)
    with pytest.raises(TypeError):
        redas_gemm.gemm(a.double(), b.double(), **TILE)
    with pytest.raises(TypeError):
        redas_gemm.gemm(a, b, out_dtype=torch.bfloat16, **TILE)
    with pytest.raises(ValueError, match="mismatch"):
        redas_gemm.gemm(a, b[:-1], **TILE)


def test_tile_menu_matches_the_cuda_source():
    import re
    from pathlib import Path

    src = (Path(redas_gemm.__file__).with_name("csrc")
           / "redas_gemm.cu").read_text()
    block = src[src.index("#define REDAS_TILES"):]
    block = block[:block.index("\n\n")]
    tiles = tuple(tuple(int(v) for v in t)
                  for t in re.findall(r"X\((\d+), (\d+), (\d+)\)", block))
    assert tiles == redas_gemm.TILES
