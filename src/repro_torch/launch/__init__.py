"""Drivers of the port: the trainer (``train.py``), the LLM serving
driver (``serve.py``), their step functions (``steps.py``) and the
distributed-conquer solver's mesh (``mesh.py``).  The JAX package's
trainer meshes and ``pipeline.py`` and its dry run are ROADMAP Queue 1
items 4 and 5."""
