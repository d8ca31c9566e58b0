"""Clustering result writers (XML/JSON).

Reference: hierclust/src/hierclust_{xml,json}_writer.cpp and
common/src/flatclust_{xml,json}_writer.cpp — same element/field names and
layout so downstream consumers of the reference's files work unchanged.

The port's own copy of smallk_tpu/io/writers.py, byte-equal in what it
returns and writes.
"""

from __future__ import annotations

from ..common.options import OutputFormat

_S4 = "    "
_S8 = _S4 * 2
_S12 = _S4 * 3
_S16 = _S4 * 4


class HierclustXmlWriter:
    """Reference: hierclust/src/hierclust_xml_writer.cpp."""

    def write_header(self, f, doc_count):
        f.write('<?xml version="1.0"?>\n')
        f.write(f'<DataSet id="{doc_count}">\n')

    def write_node(self, f, node_id, parent_id, is_left_child, left_child_id,
                   right_child_id, doc_count, term_indices, dictionary):
        f.write(f'{_S4}<node id="{node_id}">\n')
        f.write(f"{_S8}<parent_id>{parent_id}</parent_id>\n")
        f.write(
            f"{_S8}<left_child>{'true' if is_left_child else 'false'}"
            "</left_child>\n"
        )
        f.write(f"{_S8}<left_child_id>{left_child_id}</left_child_id>\n")
        f.write(f"{_S8}<right_child_id>{right_child_id}</right_child_id>\n")
        f.write(f"{_S8}<doc_count>{doc_count}</doc_count>\n")
        f.write(f"{_S8}<top_terms>\n")
        for t in term_indices:
            f.write(f'{_S12}<term name="{dictionary[t]}"/>\n')
        f.write(f"{_S8}</top_terms>\n")
        f.write(f"{_S4}</node>\n")

    def write_footer(self, f):
        f.write("</DataSet>\n")


class HierclustJsonWriter:
    """Reference: hierclust/src/hierclust_json_writer.cpp."""

    def __init__(self):
        self._nodes_written = 0

    def write_header(self, f, doc_count):
        f.write("{\n")
        f.write(f'{_S4}"doc_count": {doc_count},\n')
        f.write(f'{_S4}"nodes": [\n')
        self._nodes_written = 0

    def write_node(self, f, node_id, parent_id, is_left_child, left_child_id,
                   right_child_id, doc_count, term_indices, dictionary):
        if self._nodes_written > 0:
            f.write(",\n")
        f.write(f"{_S8}{{\n")
        f.write(f'{_S12}"id": {node_id},\n')
        f.write(f'{_S12}"parent_id": {parent_id},\n')
        f.write(
            f'{_S12}"left_child": {"true" if is_left_child else "false"},\n'
        )
        f.write(f'{_S12}"left_child_id": {left_child_id},\n')
        f.write(f'{_S12}"right_child_id": {right_child_id},\n')
        f.write(f'{_S12}"doc_count": {doc_count}')
        if term_indices:
            f.write(",\n")
            f.write(f'{_S12}"top_terms": [\n')
            terms = [f'{_S16}"{dictionary[t]}"' for t in term_indices]
            f.write(",\n".join(terms) + "\n")
            f.write(f"{_S12}]\n")
        else:
            f.write("\n")
        f.write(f"{_S8}}}")
        self._nodes_written += 1

    def write_footer(self, f):
        f.write(f"\n{_S4}]\n}}\n")


class FlatclustXmlWriter:
    """Reference: common/src/flatclust_xml_writer.cpp + the emit loop in
    common/src/flat_clust_output.cpp:110-134 (doc_count per node; top terms
    only for clusters that received documents)."""

    def write(self, f, num_docs, doc_counts, term_indices_by_cluster,
              dictionary):
        f.write('<?xml version="1.0"?>\n')
        f.write(f'<DataSet id="{num_docs}">\n')
        for c, terms in enumerate(term_indices_by_cluster):
            count = doc_counts.get(c, 0)
            f.write(f'{_S4}<node id="{c}">\n')
            f.write(f"{_S8}<doc_count>{count}</doc_count>\n")
            if count > 0:
                f.write(f"{_S8}<top_terms>\n")
                for t in terms:
                    f.write(f'{_S12}<term name="{dictionary[t]}"/>\n')
                f.write(f"{_S8}</top_terms>\n")
            f.write(f"{_S4}</node>\n")
        f.write("</DataSet>\n")


class FlatclustJsonWriter:
    """Reference: common/src/flatclust_json_writer.cpp."""

    def write(self, f, num_docs, doc_counts, term_indices_by_cluster,
              dictionary):
        f.write("{\n")
        f.write(f'{_S4}"doc_count": {num_docs},\n')
        f.write(f'{_S4}"nodes": [\n')
        chunks = []
        for c, terms in enumerate(term_indices_by_cluster):
            count = doc_counts.get(c, 0)
            lines = [f"{_S8}{{", f'{_S12}"id": {c},']
            if count > 0:
                lines.append(f'{_S12}"doc_count": {count},')
                lines.append(f'{_S12}"top_terms": [')
                lines.append(
                    ",\n".join(f'{_S16}"{dictionary[t]}"' for t in terms)
                )
                lines.append(f"{_S12}]")
            else:
                lines.append(f'{_S12}"doc_count": {count}')
            lines.append(f"{_S8}}}")
            chunks.append("\n".join(lines))
        f.write(",\n".join(chunks))
        f.write(f"\n{_S4}]\n}}\n")


def make_hierclust_writer(fmt: OutputFormat):
    """Reference: CreateHierclustWriter factory (hierclust_writer.hpp)."""
    if fmt == OutputFormat.XML:
        return HierclustXmlWriter()
    return HierclustJsonWriter()


def make_flatclust_writer(fmt: OutputFormat):
    if fmt == OutputFormat.XML:
        return FlatclustXmlWriter()
    return FlatclustJsonWriter()
