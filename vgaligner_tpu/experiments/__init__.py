"""Experiment/validation harness (SURVEY L8).

The device analog of the reference's experiments-snakemake pipeline
(rs-vgaligner experiments-snakemake/Snakefile:7-151): per HLA-zoo
graph, simulate reads from the embedded paths (the vg-sim protocol,
seed 77), run the full index+map+align pipeline, and score per-read
path Jaccard against the ground-truth node ranges (gafcompare.py
semantics).
"""
