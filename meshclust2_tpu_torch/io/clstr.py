"""CD-HIT CLSTR output writer (ClusterFactory.cpp:403-435).

Format:
    >Cluster <n>
    <i>\t<len>nt, <header>... [*]
with '*' marking the member whose id equals the center's id.
"""
from __future__ import annotations

from typing import List, Sequence


def write_clstr(path: str, clusters: Sequence[dict]) -> None:
    """clusters: iterable of {"members": [(length, header, is_center)], ...};
    empty clusters are skipped (ClusterFactory.cpp:411-413)."""
    with open(path, "w") as f:
        counter = 0
        for cl in clusters:
            members = cl["members"]
            if not members:
                continue
            f.write(f">Cluster {counter}\n")
            for pt, (length, header, is_center) in enumerate(members):
                star = "*" if is_center else ""
                f.write(f"{pt}\t{length}nt, {header}... {star}\n")
            counter += 1


def parse_clstr(path: str) -> List[List[dict]]:
    """Parse a CLSTR file into clusters of member dicts (test helper)."""
    clusters: List[List[dict]] = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">Cluster"):
                clusters.append([])
            elif line.strip():
                body = line.split("\t", 1)[1]
                lenpart, rest = body.split("nt, ", 1)
                is_center = rest.rstrip().endswith("*")
                marker = rest.rfind("... ")
                if marker == -1:
                    raise ValueError(f"malformed CLSTR member line: {line!r}")
                header = rest[:marker]
                clusters[-1].append(
                    {"length": int(lenpart), "header": header, "center": is_center}
                )
    return clusters
