"""The estimate path: GOPs through the port's ``gop.code_gop``, rates
estimated on the device."""

from __future__ import annotations

from typing import Dict


class EstimatePath:
    """GOPs through ``gop.code_gop``: rates estimated on the device."""

    spans = ("forward_one_stage", "inverse_mctf")

    def __init__(self, model, mix, device):
        from learned_pmctf_tpu_torch.gop import code_gop
        self.model, self.mix, self.device, self._code = model, mix, device, code_gop
        self.span_target = model

    def run(self, luma, chroma) -> Dict:
        return self._code(self.model, luma, chroma, self.mix["q_index"], device=self.device)

    def counters(self) -> Dict:
        return {}

    def reset_counters(self):
        pass

    def close(self):
        pass


build = EstimatePath
