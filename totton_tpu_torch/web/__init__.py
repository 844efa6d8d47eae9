"""Web control UI/API: copies of the JAX package's ``web/`` (the aiohttp +
Jinja2 app, its templates and static files, i18n, and the config, EQ,
daemon and restart services). ``totton-web-torch`` serves it; it speaks
to the port's streamer over the ZeroMQ control endpoint.
"""
