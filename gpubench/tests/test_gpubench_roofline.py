"""The kernels' byte arithmetic against counts made by hand."""

import numpy as np

from gpubench import roofline


def table(nb: int, KW: int, keys: list[tuple[int, int, tuple]]):
    """krows [nb, 4*KW] with `keys` placed at (bucket, way)."""
    kr = np.zeros((nb, 4 * KW), dtype=np.uint32)
    for b, w, key in keys:
        kr[b, w * KW: w * KW + len(key)] = key
        kr[b, w * KW + len(key)] = 1  # used
    return kr


def test_lowbias32_matches_a_hand_mix():
    def mix(h):
        h ^= h >> 16
        h = (h * 0x7FEB352D) & 0xFFFFFFFF
        h ^= h >> 15
        h = (h * 0x846CA68B) & 0xFFFFFFFF
        return h ^ (h >> 16)

    key = [0x0A000002, 0x1234]
    want = mix(mix(key[0] ^ roofline.SEED1) ^ key[1])
    assert int(roofline.lowbias32(np.array([key], dtype=np.uint32), roofline.SEED1)[0]) == want


def test_k1_bytes_by_hand():
    nb, KW, K, V = 16, 8, 2, 8
    q = np.array([[1, 2], [3, 4], [5, 6]], dtype=np.uint32)
    b1 = (roofline.lowbias32(q, roofline.SEED1) & np.uint64(nb - 1)).astype(int)
    b2 = (roofline.lowbias32(q, roofline.SEED2) & np.uint64(nb - 1)).astype(int)
    # key 0 in its b1, key 1 in its b2 (way 3), key 2 missing
    kr = table(nb, KW, [(b1[0], 0, (1, 2)), (b2[1], 3, (3, 4))])
    if b1[1] == b2[1]:  # the same bucket: key 1 is then found in b1 too
        kr = table(nb, KW, [(b1[0], 0, (1, 2))])
    stash = np.zeros((4, KW), dtype=np.uint32)
    got = roofline.k1_bytes(kr, stash, V, q)
    found = 2 if b1[1] != b2[1] else 1
    in_b1 = 1
    rows = 2 * 3 - in_b1
    want = 3 * K * 4 + rows * 4 * KW * 4 + found * V * 4 + 4 * KW * 4 + 3 * (1 + 4 + V * 4)
    assert got == want


def test_k2_bytes_by_hand():
    assert roofline.k2_bytes(100, "prefix") == 100 * 8 + 100 * 4
    assert roofline.k2_bytes(100, "both") == 100 * 8 + 2 * 100 * 4


def test_share_is_least_time_over_measured_time():
    card = roofline.DEFAULT_CARD
    bw = roofline.peak(card)["hbm_bytes_per_s"]
    assert abs(roofline.share_pct(bw * 1e-3, 4e-3, card) - 25.0) < 1e-9
    assert roofline.share_pct(0, 1.0, card) is None
