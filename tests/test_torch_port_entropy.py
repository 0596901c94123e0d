"""Port parity, the host entropy side: learned_pmctf_tpu_torch's rANS copy,
CDF quantizer, table builders, index mapping and stream containers
against the golden streams and the JAX package.

Where the two frameworks' f32 math differs by an ulp (XLA's CPU ``log``
and ``expm1`` are its own approximations, neither torch's nor numpy's),
a test states the allowance it holds and checks that the construction
itself is exact: fed the JAX package's f32 CDF values, the port builds
the JAX package's tables entry for entry.

(The CDF quantizer and tables are in test_torch_port_entropy_2.py, the
indexes, containers and round trips in _3.py.)
"""

import glob
import os

import numpy as np
import pytest


from learned_pmctf_tpu_torch import native

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
RANS_CASES = sorted(os.path.basename(p)[5:-4]
                    for p in glob.glob(os.path.join(GOLDEN, "rans_*.npz")))


def test_port_builds_and_loads_its_own_library():
    lib = native._load()
    assert native.build() == ""  # built, and up to date
    assert lib._name == native.LIBRARY
    assert "learned_pmctf_tpu_torch" in native.LIBRARY
    assert os.path.dirname(native.SOURCES[0]).endswith(
        os.path.join("learned_pmctf_tpu_torch", "csrc", "rans"))


@pytest.mark.parametrize("name", RANS_CASES)
def test_rans_matches_golden_stream(name):
    case = dict(np.load(os.path.join(GOLDEN, f"rans_{name}.npz")))
    tables = (case["cdfs"], case["cdfs_sizes"], case["offsets"])
    parts = int(case["stream_part"])
    for multithread in (False, True):
        enc = native.RansEncoder(multithread, parts)
        enc.encode_with_indexes(case["symbols"], case["indexes"], *tables)
        enc.flush()
        assert enc.get_encoded_stream() == case["stream"].tobytes(), (name, multithread)
    dec = native.RansDecoder(parts)
    dec.set_stream(case["stream"].tobytes())
    out = dec.decode_stream(case["indexes"], *tables)
    keep = case["indexes"] >= 0
    np.testing.assert_array_equal(out[keep], case["symbols"].astype(np.int16)[keep])
