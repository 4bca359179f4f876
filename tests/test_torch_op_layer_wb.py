"""The reference package's white balances on [..., H, W, 3] frames
(ops/white_balance.py, ops/learned_wb.py) against the JAX functions on the
CPU: 0 mismatching bytes at every leading shape and size of
util_op_layer."""

import pytest
import torch
from util_op_layer import CASE_IDS, CASES, assert_equal, image

from raw_image_pipeline_tpu.ops import learned_wb as jlearned
from raw_image_pipeline_tpu.ops import white_balance as jwb
from raw_image_pipeline_tpu_torch.ops import learned_wb as plearned
from raw_image_pipeline_tpu_torch.ops import white_balance as pwb

# name -> (jax call, port call) on one image
WB = {
    "white_balance.balance_white_simple": (lambda x: jwb.balance_white_simple(x, 2.0),
                                           lambda x: pwb.balance_white_simple(x, 2.0)),
    "white_balance.balance_white_grey_world": (
        lambda x: jwb.balance_white_grey_world(x, 0.9),
        lambda x: pwb.balance_white_grey_world(x, 0.9)),
    "white_balance.balance_white_pca": (jwb.balance_white_pca, pwb.balance_white_pca),
    "white_balance.balance_white_learned": (lambda x: jwb.balance_white_learned(x, 0.8),
                                            lambda x: pwb.balance_white_learned(x, 0.8)),
    "learned_wb.balance_white_learned_model": (
        lambda x: jlearned.balance_white_learned_model(x, 0.95),
        lambda x: plearned.balance_white_learned_model(x, 0.95)),
}


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("name", sorted(WB))
def test_white_balance_equals_reference(name, case):
    lead, (h, w) = case
    x = image(len(name) + h, lead, h, w)
    jfn, pfn = WB[name]
    assert_equal(pfn(torch.as_tensor(x)), jfn(x))
