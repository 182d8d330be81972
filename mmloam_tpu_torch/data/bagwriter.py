"""Minimal rosbag 2.0 writer — test fixtures for the native decoder (an
unchanged copy of mmloam_tpu/data/bagwriter.py).

Writes uncompressed single-chunk bags containing sensor_msgs/Imu,
sensor_msgs/PointCloud2 and livox_ros_driver/CustomMsg messages, enough to
round-trip the reference's three input topics (SURVEY.md §1 L0) without any
ROS installation.  Also used to convert synthetic sequences into bag form
so the full ingest path (bag -> native decoder -> tensors -> pipeline) can
be exercised end to end.
"""

from __future__ import annotations

import struct


def _header(fields: dict) -> bytes:
    out = b""
    for k, v in fields.items():
        item = k.encode() + b"=" + v
        out += struct.pack("<I", len(item)) + item
    return out


def _record(header_fields: dict, data: bytes) -> bytes:
    h = _header(header_fields)
    return struct.pack("<I", len(h)) + h + struct.pack("<I", len(data)) + data


def _time(t: float) -> bytes:
    secs = int(t)
    nsecs = int(round((t - secs) * 1e9))
    if nsecs >= 1_000_000_000:
        secs += 1
        nsecs -= 1_000_000_000
    return struct.pack("<II", secs, nsecs)


def _ros_header(seq: int, t: float, frame_id: str = "") -> bytes:
    fid = frame_id.encode()
    return (struct.pack("<I", seq) + _time(t)
            + struct.pack("<I", len(fid)) + fid)


def serialize_imu(seq, t, gyr, acc) -> bytes:
    out = _ros_header(seq, t)
    out += struct.pack("<4d", 1.0, 0.0, 0.0, 0.0)   # orientation
    out += struct.pack("<9d", *([0.0] * 9))
    out += struct.pack("<3d", *gyr)
    out += struct.pack("<9d", *([0.0] * 9))
    out += struct.pack("<3d", *acc)
    out += struct.pack("<9d", *([0.0] * 9))
    return out


def serialize_pointcloud2(seq, t, xyz, intensity, ring, time_rel) -> bytes:
    """Velodyne-style cloud: x,y,z,intensity f32 + ring u16 + time f32."""
    n = len(xyz)
    point_step = 4 * 4 + 2 + 4
    out = _ros_header(seq, t)
    out += struct.pack("<II", 1, n)                  # height, width
    fields = [(b"x", 0, 7), (b"y", 4, 7), (b"z", 8, 7),
              (b"intensity", 12, 7), (b"ring", 16, 4), (b"time", 18, 7)]
    out += struct.pack("<I", len(fields))
    for name, off, dt in fields:
        out += struct.pack("<I", len(name)) + name
        out += struct.pack("<IBI", off, dt, 1)
    out += struct.pack("<B", 0)                      # is_bigendian
    out += struct.pack("<II", point_step, point_step * n)
    data = b"".join(
        struct.pack("<4fHf", xyz[i][0], xyz[i][1], xyz[i][2],
                    intensity[i], ring[i], time_rel[i])
        for i in range(n))
    out += struct.pack("<I", len(data)) + data
    out += struct.pack("<B", 1)                      # is_dense
    return out


def serialize_pointcloud2_ouster(seq, t, xyz, intensity, ring,
                                  t_ns) -> bytes:
    """Ouster-style cloud (preprocess.h ouster_ros::Point): x,y,z,intensity
    f32 + t u32 (nanoseconds from scan start) + reflectivity u16 + ring u8
    + ambient u16 + range u32."""
    n = len(xyz)
    point_step = 16 + 4 + 2 + 1 + 2 + 4
    out = _ros_header(seq, t)
    out += struct.pack("<II", 1, n)
    fields = [(b"x", 0, 7), (b"y", 4, 7), (b"z", 8, 7),
              (b"intensity", 12, 7), (b"t", 16, 6),
              (b"reflectivity", 20, 4), (b"ring", 22, 2),
              (b"ambient", 23, 4), (b"range", 25, 6)]
    out += struct.pack("<I", len(fields))
    for name, off, dt in fields:
        out += struct.pack("<I", len(name)) + name
        out += struct.pack("<IBI", off, dt, 1)
    out += struct.pack("<B", 0)
    out += struct.pack("<II", point_step, point_step * n)
    data = b"".join(
        struct.pack("<4fIHBHI", xyz[i][0], xyz[i][1], xyz[i][2],
                    intensity[i], int(t_ns[i]), 0, ring[i], 0, 0)
        for i in range(n))
    out += struct.pack("<I", len(data)) + data
    out += struct.pack("<B", 1)
    return out


def serialize_pointcloud2_hesai(seq, t, xyz, intensity, ring,
                                t_abs) -> bytes:
    """Hesai-style cloud (preprocess.h hesai_ros::Point): x,y,z,intensity
    f32 + ring u16 + timestamp f64 (ABSOLUTE epoch seconds per point)."""
    n = len(xyz)
    point_step = 16 + 2 + 8
    out = _ros_header(seq, t)
    out += struct.pack("<II", 1, n)
    fields = [(b"x", 0, 7), (b"y", 4, 7), (b"z", 8, 7),
              (b"intensity", 12, 7), (b"ring", 16, 4),
              (b"timestamp", 18, 8)]
    out += struct.pack("<I", len(fields))
    for name, off, dt in fields:
        out += struct.pack("<I", len(name)) + name
        out += struct.pack("<IBI", off, dt, 1)
    out += struct.pack("<B", 0)
    out += struct.pack("<II", point_step, point_step * n)
    data = b"".join(
        struct.pack("<4fHd", xyz[i][0], xyz[i][1], xyz[i][2],
                    intensity[i], ring[i], float(t_abs[i]))
        for i in range(n))
    out += struct.pack("<I", len(data)) + data
    out += struct.pack("<B", 1)
    return out


def serialize_livox(seq, t, timebase_ns, pts) -> bytes:
    """livox_ros_driver/CustomMsg; pts = [(offset_ns,x,y,z,refl,tag,line)]."""
    out = _ros_header(seq, t)
    out += struct.pack("<QI", timebase_ns, len(pts))
    out += struct.pack("<B3B", 0, 0, 0, 0)           # lidar_id + rsvd
    out += struct.pack("<I", len(pts))               # points[] length
    for off, x, y, z, refl, tag, line in pts:
        out += struct.pack("<I3f3B", off, x, y, z, refl, tag, line)
    return out


_TYPES = {
    "sensor_msgs/Imu": "6a62c6daae103f4ff57a132d6f95cec2",
    "sensor_msgs/PointCloud2": "1158d486dd51d683ce2f1be655c3c181",
    "livox_ros_driver/CustomMsg": "e4d6829bdfe657cb6c21a746c86b21a6",
}


def write_bag(path, messages):
    """messages: list of (topic, type_name, stamp_sec, serialized_bytes)."""
    topics = {}
    for topic, tname, _, _ in messages:
        topics.setdefault(topic, tname)
    conn_ids = {topic: i for i, topic in enumerate(topics)}

    chunk = b""
    for topic, tname in topics.items():
        conn_hdr = _header({
            "topic": topic.encode(),
            "type": tname.encode(),
            "md5sum": _TYPES.get(tname, "0" * 32).encode(),
            "message_definition": b"",
        })
        chunk += _record({"op": b"\x07",
                          "conn": struct.pack("<I", conn_ids[topic]),
                          "topic": topic.encode()}, conn_hdr)
    for topic, tname, t, payload in messages:
        chunk += _record({"op": b"\x02",
                          "conn": struct.pack("<I", conn_ids[topic]),
                          "time": _time(t)}, payload)

    with open(path, "wb") as f:
        f.write(b"#ROSBAG V2.0\n")
        # bag header (op=0x03), padded to 4096 like real bags
        bh = _record({"op": b"\x03",
                      "index_pos": struct.pack("<Q", 0),
                      "conn_count": struct.pack("<I", len(topics)),
                      "chunk_count": struct.pack("<I", 1)},
                     b" " * 4096)
        f.write(bh)
        f.write(_record({"op": b"\x05", "compression": b"none",
                         "size": struct.pack("<I", len(chunk))}, chunk))
