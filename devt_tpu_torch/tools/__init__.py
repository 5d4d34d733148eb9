"""Offline tools: manifest admin, embedding retrieval, Grad-CAM on the
conv backbones, and the pipeline-layout checkpoint converter (ports of
``devt_tpu/tools/``)."""
