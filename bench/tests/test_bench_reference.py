"""The plain reference against hand-built packets, and its control."""

import importlib.util

import numpy as np
import torch

from benchkit import layout as L
from conftest import BENCH

spec = importlib.util.spec_from_file_location("h32_bnn", BENCH / "configs" / "h32_bnn.py")
ref = importlib.util.module_from_spec(spec)
spec.loader.exec_module(ref)

H, W = 32, 256


def packet(slot_word, payload_words, control=0):
    row = np.zeros(L.PACKET_WORDS, np.uint32)
    row[L.SLOT_WORD] = slot_word
    row[L.VERSION_WORD] = L.FORMAT_VERSION
    row[L.CONTROL_WORD] = control
    row[L.META_WORDS:] = payload_words
    return row


def weights(w1_words, b1, w2, b2):
    return {"w1p": torch.tensor(np.asarray(w1_words, np.uint32).view(np.int32)),
            "b1": torch.tensor(b1, dtype=torch.float32),
            "w2": torch.tensor(np.asarray([w2]), dtype=torch.float32),
            "b2": torch.tensor([b2], dtype=torch.float32)}


def test_scores_of_hand_built_packets():
    # unit 0 has all bits 0 (+1), unit 1 all bits 1 (-1), the rest alternate
    w1 = np.zeros((H, W), np.uint32)
    w1[1] = 0xFFFFFFFF
    w1[2:] = 0xAAAAAAAA
    b1 = np.zeros(H)
    b1[2:] = -0.5                         # the alternating units: dot 0 -> -1
    w2 = np.zeros(H)
    w2[0], w2[1], w2[2] = 0.75, 0.25, 0.125
    sw = weights(w1, b1, w2, 0.0625)
    zeros = np.zeros(W, np.uint32)        # payload all +1: dots 8192, -8192, 0
    ones = np.full(W, 0xFFFFFFFF, np.uint32)
    rows = torch.tensor(np.stack([packet(0, zeros), packet(0, ones)]).view(np.int32))
    y, margin = ref.scores(rows, sw)
    # +1 payload: h = (+1, -1, -1, ...): 0.75 - 0.25 - 0.125 + 0.0625
    # -1 payload: h = (-1, +1, -1, ...): -0.75 + 0.25 - 0.125 + 0.0625
    assert y.tolist() == [0.4375, -0.5625]
    assert 0 < margin < 1e-5


def test_slot_clamp_and_actions():
    rows = torch.tensor(np.stack([
        packet(0xFFFFFFFF, 0), packet(99, 0), packet(1, 0),
        packet(1, 0, control=L.CTRL_MONITOR_ONLY)]).view(np.int32))
    assert ref.slots_of(rows, 2).tolist() == [0, 1, 1, 1]
    verdicts = torch.tensor([False, True, True, True])
    assert ref.actions_of(rows, verdicts).tolist() == [
        L.ACTION_FORWARD, L.ACTION_DROP, L.ACTION_DROP, L.ACTION_FLAG]


def test_tf32_rounding():
    # the spacing is 2**-10 on [1, 2) and 2**-9 on [2, 4); ties go to even
    x = torch.tensor([1.0, 1 + 2**-11, 1 + 2**-10 + 2**-12, -3 - 2**-10 - 2**-12,
                      -3 - 2**-11])
    assert ref.tf32(x).tolist() == [1.0, 1.0, 1 + 2**-10, -3 - 2**-9, -3.0]


def test_control_flips_verdicts_the_reference_decides():
    g = torch.Generator().manual_seed(7)
    rows = torch.randint(-2**31, 2**31, (16384, L.PACKET_WORDS), generator=g,
                         dtype=torch.int32)
    sw = {"w1p": torch.randint(-2**31, 2**31, (H, W), generator=g, dtype=torch.int32),
          "b1": torch.randn(H, generator=g) * 8,
          "w2": torch.randn(1, H, generator=g) / H**0.5,
          "b2": torch.randn(1, generator=g) * 0.1}
    y, m = ref.scores(rows, sw)
    yc, _ = ref.scores(rows, sw, control=True)
    decided = y.abs() > m
    assert int((decided & ((yc > 0) != (y > 0))).sum()) >= 1
    y32 = (torch.where((ref.unpack_pm1(rows[:, 16:]) @ ref.unpack_pm1(sw["w1p"]).T
                        + sw["b1"].double()) >= 0, 1.0, -1.0).float()
           @ sw["w2"][0] + sw["b2"][0])
    # float32 in another order agrees wherever the reference decides
    assert not bool((decided & ((y32 > 0) != (y > 0))).any())
