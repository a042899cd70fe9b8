"""bench.py needs a GPU: without one it prints no metric and fails."""
import bench


def test_bench_fails_without_gpu(monkeypatch, capsys):
    corpus = bench.make_corpus(1 << 16)
    monkeypatch.setattr(bench, "corpus_and_name", lambda: (corpus, "mix"))
    monkeypatch.setattr(bench, "reference_numbers", lambda c: (None, 1.0))
    assert bench.main() == 1
    out = capsys.readouterr().out
    assert '"metric"' not in out
