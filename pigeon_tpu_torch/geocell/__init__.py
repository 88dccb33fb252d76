"""Geographic lookups on the host: boundary polygons and the metadata
augmentor."""
