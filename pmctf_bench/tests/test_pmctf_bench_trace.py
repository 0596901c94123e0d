"""The trace reduction on made-up profiler events: a kernel belongs to
the layer whose span held its launch on the host, whatever its name;
idle gaps are named by the span open at their middle."""

from pmctf_bench.trace import NO_SPAN, _innermost, reduce


class Ev:
    def __init__(self, kind, name, start, end, corr=0, thread=1):
        self._k, self._n, self._s, self._e, self._c = kind, name, start, end, corr
        self._t = thread

    def start_thread_id(self):
        return self._t

    def activity_type(self):
        return self._k

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def correlation_id(self):
        return self._c


def test_innermost_span():
    spans = [(0, 100, "gop"), (10, 40, "postprocess"), (50, 60, "four-step priors")]
    assert _innermost(spans, [5, 10, 39, 40, 55, 70, 100]) == \
        ["gop", "postprocess", "postprocess", "gop", "four-step priors", "gop", NO_SPAN]


def test_reduce_attributes_by_launch_time():
    events = [
        Ev("user_annotation", "traced gop", 0, 1000),
        Ev("user_annotation", "postprocess", 100, 200),
        Ev("user_annotation", "four-step priors", 300, 400),
        # a ctypes launch inside PostProcess's span, whose kernel runs later
        Ev("cuda_driver", "cuLaunchKernel", 150, 160, corr=7),
        Ev("kernel", "conv3x3_wgmma_kernel", 350, 500, corr=7),
        Ev("cuda_runtime", "cudaLaunchKernel", 310, 320, corr=8),
        Ev("kernel", "cudnn_conv", 500, 700, corr=8),
        Ev("cpu_op", "aten::conv2d", 300, 330, corr=7),      # another id space
        Ev("gpu_user_annotation", "postprocess", 350, 500, corr=0),
    ]
    rec = reduce(events, (0, 1000), {"postprocess", "four-step priors"})
    assert rec["layer_device_s"] == {"postprocess": 150e-9, "four-step priors": 200e-9}
    assert rec["busy_s"] == 350e-9 and rec["window_s"] == 1000e-9
    assert rec["unmatched_launches"] == 0 and rec["device_activities"] == 2
    # gaps: 0-350 (middle 175: postprocess), 700-1000 (middle 850: the gop)
    assert dict(rec["idle_gaps"]) == {"postprocess": 350e-9, "traced gop": 300e-9}
    assert [n for n, _ in rec["device_ops"]] == ["cudnn_conv", "conv3x3_wgmma_kernel"]


def test_reduce_keeps_threads_apart():
    """A worker thread's launch belongs to its own thread's span, not to
    the span the main thread has open; gaps take the main thread's."""
    events = [
        Ev("user_annotation", "traced gop", 0, 1000),
        Ev("user_annotation", "encode_one_stage", 0, 900),
        Ev("user_annotation", "postprocess", 100, 300, thread=2),
        Ev("cuda_runtime", "cudaLaunchKernel", 200, 210, corr=3, thread=2),
        Ev("kernel", "k", 400, 600, corr=3),
    ]
    rec = reduce(events, (0, 1000), {"postprocess"})
    assert rec["layer_device_s"] == {"postprocess": 200e-9}
    # gaps 0-400 and 600-1000, their middles in the main thread's encode span
    assert dict(rec["idle_gaps"]) == {"encode_one_stage": 800e-9}
