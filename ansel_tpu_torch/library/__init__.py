"""Library layer: SQLite image database, film rolls, tags, collections,
filename variables, XMP crawler, batch export, thumbnails
(`ansel_tpu/library`; reference `src/common/database.c`,
`collection.c`, `tags.c`, `variables.c`, `src/control/crawler.c`)."""

from .db import Library  # noqa: F401
