"""Median over the served requests of the program's ``http.request`` span
less its ``http.wait``: the HTTP front end's own time a request
(spantrace.http_ms)."""

from portbench.spantrace import http_ms as read  # noqa: F401
