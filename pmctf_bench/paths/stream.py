"""The stream path: GOPs written to ``.bin`` files through the port's
``PMCTFCodec`` and decoded from them by ``gop.stream_gop``."""

from __future__ import annotations

import tempfile
from typing import Dict


class StreamPath:
    """GOPs written to .bin streams through ``PMCTFCodec`` and decoded
    from them by ``gop.stream_gop``, which holds every decoded plane equal
    to the encoder side."""

    spans = ("encode_one_stage", "inverse_mctf")

    def __init__(self, model, mix, device):
        from learned_pmctf_tpu_torch.codec.video_codec import PMCTFCodec
        from learned_pmctf_tpu_torch.gop import stream_gop
        self.mix, self.device, self._code = mix, device, stream_gop
        self.codec = PMCTFCodec(model, device=device)
        self.codec.update()
        self.span_target = self.codec
        self._dir = tempfile.TemporaryDirectory(prefix="pmctf_bench_")

    def run(self, luma, chroma) -> Dict:
        out = self._code(self.codec, luma, chroma, self.mix["q_index"], self._dir.name,
                         device=self.device)
        bad = {k: v for k, v in out["max_err"].items() if v != 0.0}
        if len(out["max_err"]) != len(luma) - 1 or bad:
            raise RuntimeError(f"decoded planes differ from the encoder side: {out['max_err']}")
        return out

    def counters(self) -> Dict:
        s = self.codec.stats
        return {"syncs": s.syncs, "rans_s": s.rans_encode_s + s.rans_decode_s}

    def reset_counters(self):
        self.codec.stats.reset()

    def close(self):
        self.codec.close()
        self._dir.cleanup()


build = StreamPath
