"""Framework-free host utilities: audio file IO (``wav``, ``codecs``,
``av_codec``), CSV number formatting (``fmt``), running statistics
(``stats``), named timers (``timing``) and the on-demand native build
(``native_build``)."""
