"""
Minimal GeoTIFF writer (no GDAL).

The reference's GeoTIFF exporter goes through GDAL
(pysteps/io/exporters.py:125-240,960-1020), which is not available here.
A GeoTIFF is a plain TIFF with a handful of georeferencing tags, so this
module emits classic little-endian TIFF 6.0 directly with struct/numpy:

- one float32 image per file, ``n_bands`` planes (PlanarConfiguration=2,
  one strip per plane, uncompressed)
- ModelPixelScaleTag / ModelTiepointTag for the affine geotransform
- GeoKeyDirectory with a user-defined projected CRS whose PCSCitation
  carries the PROJ.4 string (round-trippable by this package; GDAL shows
  it as the citation)
- GDAL_NODATA for NaN handling
"""

import struct

import numpy as np

_TAG_FMT = {"H": 3, "I": 4, "d": 12, "s": 2}  # SHORT, LONG, DOUBLE, ASCII


def _pack_values(fmt, values):
    if fmt == "s":
        data = values.encode("ascii", "replace") + b"\x00"
        return data, len(data)
    values = list(np.atleast_1d(values))
    return struct.pack("<" + fmt * len(values), *values), len(values)


def write_geotiff(filename, bands, metadata, nodata=None):
    """Write (n_bands, h, w) float32 planes as a GeoTIFF.

    ``metadata`` needs x1/x2/y1/y2 (grid outer edges, reference metadata
    contract io/importers.py:19-66) and optionally ``projection``/``unit``.
    """
    bands = np.asarray(bands, np.float32)
    if bands.ndim == 2:
        bands = bands[None]
    if bands.ndim != 3:
        raise ValueError("bands must be (h, w) or (n_bands, h, w)")
    n_bands, h, w = bands.shape

    xres = (metadata["x2"] - metadata["x1"]) / w
    yres = (metadata["y2"] - metadata["y1"]) / h

    # GeoKeyDirectory: version 1.1.0, 4 keys
    proj4 = str(metadata.get("projection", ""))
    geokeys = [
        (1024, 0, 1, 1),      # GTModelTypeGeoKey = Projected
        (1025, 0, 1, 1),      # GTRasterTypeGeoKey = PixelIsArea
        (3072, 0, 1, 32767),  # ProjectedCSTypeGeoKey = user-defined
        (3073, 34737, len(proj4) + 1, 0),  # PCSCitationGeoKey -> ascii tag
    ]
    gkd = [1, 1, 0, len(geokeys)]
    for key in geokeys:
        gkd.extend(key)

    plane_bytes = h * w * 4
    # layout: header(8) | plane data | IFD | out-of-line tag values
    data_offset = 8
    ifd_offset = data_offset + n_bands * plane_bytes

    tags = []  # (tag_id, fmt, values)
    tags.append((256, "I", w))                    # ImageWidth
    tags.append((257, "I", h))                    # ImageLength
    tags.append((258, "H", [32] * n_bands))       # BitsPerSample
    tags.append((259, "H", 1))                    # Compression = none
    tags.append((262, "H", 1))                    # Photometric = BlackIsZero
    strip_offsets = [data_offset + i * plane_bytes for i in range(n_bands)]
    tags.append((273, "I", strip_offsets))        # StripOffsets
    tags.append((277, "H", n_bands))              # SamplesPerPixel
    tags.append((278, "I", h))                    # RowsPerStrip
    tags.append((279, "I", [plane_bytes] * n_bands))  # StripByteCounts
    if n_bands > 1:
        tags.append((284, "H", 2))                # PlanarConfiguration
    tags.append((339, "H", [3] * n_bands))        # SampleFormat = IEEE float
    tags.append((33550, "d", [xres, yres, 0.0]))  # ModelPixelScale
    # tiepoint: raster (0,0) -> (x1, y2) (upper-left corner)
    tags.append((33922, "d", [0.0, 0.0, 0.0,
                              float(metadata["x1"]), float(metadata["y2"]), 0.0]))
    tags.append((34735, "H", gkd))                # GeoKeyDirectory
    tags.append((34737, "s", proj4))              # GeoAsciiParams
    if nodata is not None:
        tags.append((42113, "s", str(nodata)))    # GDAL_NODATA

    tags.sort(key=lambda t: t[0])

    # assemble IFD
    ifd_size = 2 + len(tags) * 12 + 4
    overflow_offset = ifd_offset + ifd_size
    entries = b""
    overflow = b""
    for tag_id, fmt, values in tags:
        payload, count = _pack_values(fmt, values)
        entry = struct.pack("<HHI", tag_id, _TAG_FMT[fmt], count)
        if len(payload) <= 4:
            entry += payload.ljust(4, b"\x00")
        else:
            entry += struct.pack("<I", overflow_offset + len(overflow))
            overflow += payload
            if len(overflow) % 2:
                overflow += b"\x00"
        entries += entry
    ifd = struct.pack("<H", len(tags)) + entries + struct.pack("<I", 0)

    with open(filename, "wb") as f:
        f.write(struct.pack("<2sHI", b"II", 42, ifd_offset))
        f.write(np.ascontiguousarray(bands, "<f4").tobytes())
        f.write(ifd)
        f.write(overflow)
