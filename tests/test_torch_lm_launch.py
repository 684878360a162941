"""The port's serving launcher (``repro_torch.launch.serve``) against the
reference's (``repro.launch.serve``): the same flags, defaults and choices
plus ``--device``; the same printed lines on the same arguments; and
``--arch seamless-m4t-medium`` failing in both (the engine's prefill feeds
tokens only, the encoder-decoder reads frame embeddings).  The served
tokens differ: each package draws its own random weights."""

import argparse
import re
import sys

import pytest

from _torch_parity import one_torch_thread  # noqa: F401
from repro.launch import serve as jserve
from repro_torch.launch import serve as tserve

SMALL = ["--requests", "3", "--max-new-tokens", "3", "--max-seq", "64"]
LINES = [re.compile(r"served (\d+) requests, (\d+) tokens in \d+\.\d\ds "
                    r"\(\d+\.\d tok/s\), (\d+) ticks, rejected (\d+)$"),
         re.compile(r"latency p50=\d+\.\dms p99=\d+\.\dms$")]


class _Parsed(Exception):
    pass


def _reference_parser() -> argparse.ArgumentParser:
    """The parser the reference's ``main`` builds (it builds it inline)."""
    seen = {}
    real = argparse.ArgumentParser.parse_args

    def grab(self, *a, **kw):
        seen["parser"] = self
        raise _Parsed
    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(_Parsed):
            jserve.main()
    finally:
        argparse.ArgumentParser.parse_args = real
    return seen["parser"]


def _flags(parser) -> dict:
    return {a.option_strings[0]: (a.default, a.type, a.choices)
            for a in parser._actions if a.option_strings and a.option_strings[0] != "-h"}


def test_flags_are_the_reference_s_plus_device():
    ref, port = _flags(_reference_parser()), _flags(tserve.build_parser())
    assert port.pop("--device") == (None, None, None)
    assert port == ref
    assert "seamless-m4t-medium" in port["--arch"][2]


def _run_reference(monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    jserve.main()


def _printed(capsys) -> list[tuple]:
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == len(LINES), out
    return [pat.match(line).groups() for pat, line in zip(LINES, out)]


@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-130m"])
def test_printed_lines_match(monkeypatch, capsys, arch):
    argv = ["--arch", arch, *SMALL]
    _run_reference(monkeypatch, argv)
    want = _printed(capsys)
    tserve.main([*argv, "--device", "cpu"])
    got = _printed(capsys)
    assert got == want
    assert got[0] == ("3", "9", "2", "0")  # requests, tokens, ticks, rejected


def test_encoder_decoder_fails_in_both(monkeypatch):
    argv = ["--arch", "seamless-m4t-medium", *SMALL]
    with pytest.raises(KeyError, match="frames"):
        _run_reference(monkeypatch, argv)
    with pytest.raises(KeyError, match="frames"):
        tserve.main([*argv, "--device", "cpu"])
