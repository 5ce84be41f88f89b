"""Build and cache the raw Reddit-scale R-MAT arrays (CSR/CSC/permute).

bench.py and the training CLIs build this file on first use
(graph/cache.rmat_graph); this script builds it ahead of time.

Run: python scripts/build_reddit_raw.py  [out.npz]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dgnn.data.synthetic import CITATION_SHAPES
from dgnn.graph.cache import build_rmat_raw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    n, e, _, _ = CITATION_SHAPES["reddit"]
    out = (sys.argv[1] if len(sys.argv) > 1 else
           os.path.join(REPO, ".bench_cache", f"rmat_raw_{n}_{e}.npz"))
    build_rmat_raw(n, e, out)
    print(f"saved {out}")
