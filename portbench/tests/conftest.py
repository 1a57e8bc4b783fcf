"""Settings of the benchmark's own tests: the ``card`` marker, and the
fixtures the tests share."""
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none (decided here, when
    the test runs, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)


class _StandIn:
    """``capture`` on the CPU: no graph; the body runs at capture and at each
    replay, and a replay writes into the tensor that the capture returned,
    as a graph's replay does."""

    def __call__(self, body, generators=()):
        out = body()

        class Graph:
            @staticmethod
            def replay():
                new = body()
                if new is not out:
                    out.copy_(new)

        return Graph(), out


@pytest.fixture
def cpu_capture(monkeypatch):
    """The captured Monte-Carlo loop on the CPU: a stand-in for the CUDA
    graph, and the port's look for a card passing the CPU."""
    from feynmandiagram_tpu_torch import mc
    from feynmandiagram_tpu_torch.backends import compile as compile_mod
    from feynmandiagram_tpu_torch.ops import evaluator as evaluator_mod
    from feynmandiagram_tpu_torch.ops import graphs

    fake = _StandIn()
    monkeypatch.setattr(graphs, "capture", fake)
    monkeypatch.setattr(mc, "capture", fake)
    for mod in (graphs, mc, compile_mod, evaluator_mod):
        monkeypatch.setattr(mod, "require_cuda", lambda device, what: None)
    return fake
