"""Drivers of the port: the trainer (``train.py``), the LLM serving
driver (``serve.py``) and their step functions (``steps.py``).  The JAX
package's multi-device drivers (``mesh.py``, ``pipeline.py``) and its
dry run are ROADMAP Queue 1 items 4 and 5."""
