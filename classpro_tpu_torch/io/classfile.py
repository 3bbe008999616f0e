"""The fastq-like ``.class`` output format (ref ClassPro.c:289, README.md:40-52).

Per read, four lines::

    @<name> <comment>
    <sequence>
    +
    <class string>     # one of E/H/D/R per base; first K-1 positions are N
"""

from __future__ import annotations

from typing import Iterator, NamedTuple, Sequence


class ClassRecord(NamedTuple):
    header: str  # full header line including leading '@'
    seq: str
    classes: str


def class_header(name: str, comment: str | None) -> str:
    """Header line as the reference binary prints it (ClassPro.c:289):
    ``fprintf("@%s %s\\n", name, comment)`` where kseq leaves comment NULL
    for headers without one — glibc renders that as the literal string
    ``(null)``.  Reproduced for byte identity."""
    return f"@{name} {comment if comment else '(null)'}"


def write_class(path: str, records: Sequence[ClassRecord] | Iterator[ClassRecord]) -> None:
    with open(path, "w") as f:
        for r in records:
            f.write(f"{r.header}\n{r.seq}\n+\n{r.classes}\n")


def read_class(path: str) -> Iterator[ClassRecord]:
    with open(path) as f:
        while True:
            hdr = f.readline()
            if not hdr:
                return
            seq = f.readline().rstrip("\n")
            f.readline()  # '+'
            classes = f.readline().rstrip("\n")
            yield ClassRecord(hdr.rstrip("\n"), seq, classes)
