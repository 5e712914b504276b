"""Command-line tools of the PyTorch port, run as
``python -m graphinvent_tpu_torch.tools.<name>``: counterparts of the JAX
package's ``tools/*.py`` with the same names, arguments where they still
mean something and one final JSON line.  Tools that run the model take
``--device`` (``cuda``, the default, or ``cpu``); without a card ``cuda``
raises."""
