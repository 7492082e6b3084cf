"""Serving front end: the service layer (``service.py``: cache, breaker,
fallback, the generation pipeline), the aiohttp app (``app.py``: the
JAX package's routes and middleware that the port serves), engine
selection (``factory.py``) and the entry point (``__main__.py``).
"""
