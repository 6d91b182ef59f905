"""The control: the reference in the program's place with a guarantee
broken comes out not correct, and the reference in the program's place
unbroken comes out correct (the comparison is not vacuous either way)."""

import pytest

from gpubench import control, harness
from gpubench.conftest import TINY_CFG, TINY_MIX, spec


def small(cell):
    _, _, cfg, mix = harness.load_cell(cell, spec())
    return (dict(cfg, **{k: v for k, v in TINY_CFG.items() if k in cfg}),
            dict(mix, **{k: v for k, v in TINY_MIX.items() if k in mix}))


@pytest.mark.parametrize("cell,variant,caught_by", [
    ("ipoe_1m.mix_80_20", "bf16_tokens", "qos_words_off"),
    ("ipoe_1m.mix_80_20", "udp_checksum_kept", "bytes_off"),
    ("ipoe_1m.rediscover", "offer_xid_zero", "bytes_off"),
    ("serving_1m.offer_under_load", "bf16_tokens", "qos_words_off"),
    ("serving_1m.offer_under_load", "offer_xid_zero", "bytes_off"),
])
@pytest.mark.parametrize("seed", [11, 2**31 + 5, 2**33 + 1])
def test_control_is_not_correct(cell, variant, caught_by, seed):
    cfg, mix = small(cell)
    checks = control.simulate(cfg, mix, seed, 40, variant)
    assert checks[caught_by][0] > checks[caught_by][1]


@pytest.mark.parametrize("cell", ["ipoe_1m.mix_80_20", "ipoe_1m.rediscover"])
def test_unbroken_reference_is_correct(cell):
    cfg, mix = small(cell)
    checks = control.simulate(cfg, mix, 3, 40, "none")
    assert all(v <= lim for v, lim in checks.values()), checks


def test_bf16_rounds_to_nearest_even():
    import numpy as np

    # torch's float32 -> bfloat16 conversion gives the same values
    for v, want in ((312500.0, 313344.0), (150.0, 150.0), (1.00390625, 1.0),
                    (1.01171875, 1.015625)):
        assert control.bf16(np.float32(v)) == np.float32(want)
