"""Input data for the port: transforms, the ImageFolder dataset, the
threaded ``Loader`` and synthetic trees."""
