"""The port's word primitives against the JAX package, bit for bit:
lowbias32 hashing for K = 1..8, clamped byte loads and select-writes, and
the Internet checksums. Inputs are made with numpy from a seed and handed
to both packages; the tolerance is zero."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from bng_tpu.ops import bytes as jbytes
from bng_tpu.ops import checksum as jcsum
from bng_tpu.ops import hashing as jhash
from bng_tpu_torch.ops import bytes as tbytes
from bng_tpu_torch.ops import checksum as tcsum
from bng_tpu_torch.ops import hashing as thash

pytestmark = pytest.mark.torch_port


def bits(x):
    """Any int/bool/float array or tensor -> its uint32 bit patterns (bool
    kept): the "same bits" every port test compares. Shared by the other
    tests/test_torch_*.py files."""
    a = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if a.dtype == bool:
        return a
    if a.dtype.kind == "f":
        return a.astype(np.float32).view(np.uint32)
    return (a.astype(np.int64) & 0xFFFFFFFF).astype(np.uint32)


@pytest.mark.parametrize("K", range(1, 9))
def test_hash_words_matches_reference(K):
    rng = np.random.default_rng(100 + K)
    words = rng.integers(0, 2**32, size=(K, 257), dtype=np.uint32)
    words[:, :3] = [0, 0xFFFFFFFF, 0x80000000]  # edge words in every column
    for seed in (jhash.SEED1, jhash.SEED2):
        ref = np.asarray(jhash.hash_words([jnp.asarray(w) for w in words], seed))
        got = thash.hash_words([torch.from_numpy(w.astype(np.int64)) for w in words], int(seed))
        assert np.array_equal(bits(got), ref)
        # the numpy host path of the port agrees too
        got_np = thash.hash_words([w.astype(np.int64) for w in words], int(seed))
        assert np.array_equal(got_np.astype(np.uint32), ref)


def _batch(seed, B=24, L=64):
    rng = np.random.default_rng(seed)
    pkt = rng.integers(0, 256, size=(B, L), dtype=np.uint8)
    # offsets inside, at the edges of, and beyond the row (clamped reads)
    offs = rng.integers(-6, L + 6, size=B).astype(np.int32)
    offs[:4] = [0, L - 1, -3, L + 2]
    val = rng.integers(0, 2**32, size=B, dtype=np.uint32)
    mask = rng.random(B) < 0.6
    return pkt, offs, val, mask


def test_loads_at_clamped_offsets():
    pkt, offs, _, _ = _batch(1)
    jp, jo = jnp.asarray(pkt), jnp.asarray(offs)
    tp, to = torch.from_numpy(pkt), torch.from_numpy(offs.astype(np.int64))
    for jf, tf in ((jbytes.u8_at, tbytes.u8_at), (jbytes.be16_at, tbytes.be16_at),
                   (jbytes.be32_at, tbytes.be32_at)):
        assert np.array_equal(bits(tf(tp, to)), bits(jf(jp, jo)))
    assert np.array_equal(tbytes.bytes_at(tp, to, 7).numpy(),
                          np.asarray(jbytes.bytes_at(jp, jo, 7)))


@pytest.mark.parametrize("nbytes,masked", [(1, False), (2, False), (4, False),
                                           (1, True), (2, True), (4, True)])
def test_select_writes(nbytes, masked):
    pkt, offs, val, mask = _batch(10 + nbytes)
    name = {1: "u8", 2: "be16", 4: "be32"}[nbytes]
    suffix = "_masked" if masked else ""
    jf = getattr(jbytes, f"scatter_{name}_at{suffix}")
    tf = getattr(tbytes, f"scatter_{name}_at{suffix}")
    jargs = (jnp.asarray(pkt), jnp.asarray(offs), jnp.asarray(val))
    targs = (torch.from_numpy(pkt), torch.from_numpy(offs.astype(np.int64)),
             torch.from_numpy(val.astype(np.int64)))
    if masked:
        jargs += (jnp.asarray(mask),)
        targs += (torch.from_numpy(mask),)
    assert np.array_equal(tf(*targs).numpy(), np.asarray(jf(*jargs)))


def test_segment_builders():
    rng = np.random.default_rng(5)
    v = rng.integers(0, 2**32, size=16, dtype=np.uint32)
    tv = torch.from_numpy(v.astype(np.int64))
    for name in ("be16_seg", "be32_seg", "u8_seg"):
        assert np.array_equal(getattr(tbytes, name)(tv).numpy(),
                              np.asarray(getattr(jbytes, name)(jnp.asarray(v))))
    assert np.array_equal(tbytes.const_seg(3, 1, 2, 255).numpy(),
                          np.asarray(jbytes.const_seg(3, 1, 2, 255)))


def test_checksums():
    rng = np.random.default_rng(9)
    B = 200
    csum = rng.integers(0, 2**16, size=B, dtype=np.uint32)
    old32, new32 = (rng.integers(0, 2**32, size=B, dtype=np.uint32) for _ in range(2))
    old16, new16 = (rng.integers(0, 2**16, size=B, dtype=np.uint32) for _ in range(2))
    csum[:3] = [0, 0xFFFF, 0x8000]
    J = jnp.asarray
    T = lambda a: torch.from_numpy(a.astype(np.int64))  # noqa: E731
    assert np.array_equal(bits(tcsum.csum_update32(T(csum), T(old32), T(new32))),
                          bits(jcsum.csum_update32(J(csum), J(old32), J(new32))))
    assert np.array_equal(bits(tcsum.csum_update16(T(csum), T(old16), T(new16))),
                          bits(jcsum.csum_update16(J(csum), J(old16), J(new16))))
    words = [rng.integers(0, 2**16, size=B, dtype=np.uint32) for _ in range(10)]
    assert np.array_equal(bits(tcsum.ipv4_header_checksum([T(w) for w in words])),
                          bits(jcsum.ipv4_header_checksum([J(w) for w in words])))
    acc = rng.integers(0, 2**32, size=B, dtype=np.uint32)
    assert np.array_equal(bits(tcsum.fold16(T(acc))), bits(jcsum.fold16(J(acc))))
