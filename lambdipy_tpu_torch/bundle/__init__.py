"""The bundle format of the port: the manifest (``format.py``), the flat
params file (``flatpack.py``) and the base layer's skew check
(``baselayer.py``), copies of ``lambdipy_tpu/bundle/`` that read into
torch."""
