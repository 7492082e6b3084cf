"""Serving front end: the request pipeline (``service.py``), a lean
aiohttp app (``app.py``: ``POST /kubectl-command``, ``GET /health``),
engine selection (``factory.py``) and the entry point (``__main__.py``).
"""
