"""The plain references of the benchmark's entries: one module an entry of
``benchmark/entries``, found by the entry's name, each written from the
algorithm in plain PyTorch, importing nothing of the port and taking
nothing it made.  ``forecast(request, config, seed, device)`` returns what
the entry's ``program`` returns for the same request and seed."""
