"""Embedding retrieval over exported test embeddings.

The port of ``devt_tpu/tools/nearest_neighbour.py`` (the reference's
``src/data_processing/tools/nearest_neighbour.py:18-79``): it loads the
``embed_dict`` pickle that the DisplayResults callback exports
(``train/callbacks.py``), indexes the embeddings, and answers k-nearest
queries through a library call, a command line, a TensorBoard-projector
export and, where Streamlit is importable, a small UI.

The index is host code, as JAX's is: the exact-kNN ``data/native.py:
AnnIndex`` where the native library builds, else numpy (``route`` says
which ran).  Both give euclidean distances; no device is involved.

Usage:
    python -m devt_tpu_torch.tools.nearest_neighbour embed_dict --query 3 --k 10
"""

from __future__ import annotations

import argparse
import os
import pickle
from typing import Any

import numpy as np


class RetrievalIndex:
    """The records of an ``embed_dict`` pickle (id → {"embedding", "path",
    "actual", "predicted", …}) and an index over their embeddings."""

    def __init__(self, embed_dict_path: str):
        with open(embed_dict_path, "rb") as f:
            self.records: dict[int, dict[str, Any]] = pickle.load(f)
        keys = sorted(self.records)
        self.ids = keys
        vecs = np.stack([np.asarray(self.records[k]["embedding"], np.float32)
                         for k in keys])
        self.dim = vecs.shape[1]
        from devt_tpu_torch.data import native

        if native.available():
            self.index = native.AnnIndex(self.dim)
            for i, v in enumerate(vecs):
                self.index.add_item(i, v)
            self.index.build(750)
            self._vecs = None
            self.route = "native"
        else:
            self.index = None
            self._vecs = vecs
            self.route = "numpy"

    def neighbours(self, query_vec, k: int = 10
                   ) -> list[tuple[int, float, dict]]:
        q = np.asarray(query_vec, np.float32)
        if self.index is not None:
            ids, dists = self.index.get_nns_by_vector(
                q, k, include_distances=True)
        else:
            d = np.linalg.norm(self._vecs - q, axis=1)
            order = np.argsort(d)[:k]
            ids, dists = order.tolist(), d[order].tolist()
        return [(self.ids[i], float(dist), self.records[self.ids[i]])
                for i, dist in zip(ids, dists)]

    def neighbours_of(self, record_id: int, k: int = 10):
        rec = self.records[record_id]
        return self.neighbours(rec["embedding"], k)


def export_projector(index: RetrievalIndex, out_dir: str) -> str:
    """Write the embeddings in TensorBoard-projector format (the
    reference's ``tsne_projection`` through ``SummaryWriter.add_embedding``):
    ``vectors.tsv``, ``metadata.tsv`` and ``projector_config.pbtxt``,
    byte for byte what the JAX package writes."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "vectors.tsv"), "w") as f:
        for rid in index.ids:
            vec = np.asarray(index.records[rid]["embedding"], np.float32)
            f.write("\t".join(f"{v:.6g}" for v in vec.ravel()) + "\n")
    with open(os.path.join(out_dir, "metadata.tsv"), "w") as f:
        for rid in index.ids:
            f.write(str(index.records[rid].get("path", rid)) + "\n")
    with open(os.path.join(out_dir, "projector_config.pbtxt"), "w") as f:
        f.write('embeddings {\n  tensor_path: "vectors.tsv"\n'
                '  metadata_path: "metadata.tsv"\n}\n')
    return out_dir


def format_result(rid: int, dist: float, rec: dict) -> str:
    return (f"#{rid:<5} d={dist:.4f}  path={rec.get('path')}  "
            f"actual={rec.get('actual')}  predicted={rec.get('predicted')}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("embed_dict", help="pickle exported by DisplayResults")
    parser.add_argument("--query", type=int, default=0,
                        help="record id to query neighbours of")
    parser.add_argument("--k", type=int, default=10)
    parser.add_argument("--serve", action="store_true",
                        help="launch the Streamlit UI (needs streamlit)")
    parser.add_argument("--export-projector", metavar="DIR", default=None,
                        help="write TensorBoard-projector TSVs to DIR")
    args = parser.parse_args(argv)

    index = RetrievalIndex(args.embed_dict)
    if args.export_projector:
        print(f"projector export: "
              f"{export_projector(index, args.export_projector)}")
        return
    if args.serve:
        _serve(index)
        return
    rec = index.records[args.query]
    print(f"query #{args.query}: path={rec.get('path')} "
          f"actual={rec.get('actual')}")
    for rid, dist, r in index.neighbours_of(args.query, args.k):
        print(format_result(rid, dist, r))


def _serve(index: RetrievalIndex):  # pragma: no cover — needs streamlit
    import streamlit as st

    st.title("devt_tpu_torch embedding retrieval")
    rid = st.number_input("record id", min_value=min(index.ids),
                          max_value=max(index.ids), value=index.ids[0])
    k = st.slider("neighbours", 1, 50, 10)
    for nid, dist, rec in index.neighbours_of(int(rid), int(k)):
        st.write(f"**#{nid}** d={dist:.4f} — {rec.get('path')}")
        st.caption(f"actual {rec.get('actual')} | "
                   f"predicted {rec.get('predicted')}")


if __name__ == "__main__":
    main()
