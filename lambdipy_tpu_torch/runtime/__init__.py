"""Serving runtime of the port: handlers and the HTTP server."""
