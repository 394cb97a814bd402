"""Entry points of the port: the HTTP/SSE server (``serve_api``), its smoke
client (``serve_smoke_client``) and the serving CLI (``serve``)."""
