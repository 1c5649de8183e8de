// camera_sim — loopback ESP32-CAM firmware simulator (C++).
//
// Implements the HTTP surface of the reference camera firmware
// (reference: Code/esp32cam.ino):
//   * GET /stream     — multipart/x-mixed-replace MJPEG stream
//                       (stream_handler, esp32cam.ino:70-126); frames are a
//                       synthetic embedded JPEG (the simulator has no sensor)
//   * GET /control?var=framesize&val=N — runtime framesize control
//                       (cmd_handler, :129-168)
//   * GET /imu_data   — MPU6050 raw IMU JSON (:171-190)
//   * GET /ads_data   — ADS1115 4-channel ADC JSON (:193-211)
//   * GET /events     — SSE combined IMU+ADC stream (:214-269)
// Default port 81 (:277).
//
// Build: opendog_tpu_torch/native/build.py at first use, or make
// Usage: camera_sim [--port N]

#include <arpa/inet.h>
#include <netinet/in.h>
#include <signal.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <cmath>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>

namespace {

// Minimal valid 1x1 grayscale JPEG (synthetic "frame").
const unsigned char kJpeg[] = {
    0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 0x4A, 0x46, 0x49, 0x46, 0x00, 0x01,
    0x01, 0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00, 0xFF, 0xDB, 0x00, 0x43,
    0x00, 0x08, 0x06, 0x06, 0x07, 0x06, 0x05, 0x08, 0x07, 0x07, 0x07, 0x09,
    0x09, 0x08, 0x0A, 0x0C, 0x14, 0x0D, 0x0C, 0x0B, 0x0B, 0x0C, 0x19, 0x12,
    0x13, 0x0F, 0x14, 0x1D, 0x1A, 0x1F, 0x1E, 0x1D, 0x1A, 0x1C, 0x1C, 0x20,
    0x24, 0x2E, 0x27, 0x20, 0x22, 0x2C, 0x23, 0x1C, 0x1C, 0x28, 0x37, 0x29,
    0x2C, 0x30, 0x31, 0x34, 0x34, 0x34, 0x1F, 0x27, 0x39, 0x3D, 0x38, 0x32,
    0x3C, 0x2E, 0x33, 0x34, 0x32, 0xFF, 0xC0, 0x00, 0x0B, 0x08, 0x00, 0x01,
    0x00, 0x01, 0x01, 0x01, 0x11, 0x00, 0xFF, 0xC4, 0x00, 0x1F, 0x00, 0x00,
    0x01, 0x05, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x00, 0x00, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08,
    0x09, 0x0A, 0x0B, 0xFF, 0xC4, 0x00, 0xB5, 0x10, 0x00, 0x02, 0x01, 0x03,
    0x03, 0x02, 0x04, 0x03, 0x05, 0x05, 0x04, 0x04, 0x00, 0x00, 0x01, 0x7D,
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA, 0xFF, 0xDA, 0x00, 0x08, 0x01, 0x01,
    0x00, 0x00, 0x3F, 0x00, 0xFB, 0xD0, 0xFF, 0xD9};

std::atomic<int> g_framesize{6};  // VGA default
std::atomic<bool> g_running{true};

std::string now_imu_json() {
  double t = std::chrono::duration<double>(
                 std::chrono::steady_clock::now().time_since_epoch())
                 .count();
  char buf[256];
  // schema parity with esp32cam.ino:171-190 (raw accel/gyro/temp)
  std::snprintf(buf, sizeof(buf),
                "{\"accel\":{\"x\":%.3f,\"y\":%.3f,\"z\":9.810},"
                "\"gyro\":{\"x\":%.3f,\"y\":0.000,\"z\":0.000},"
                "\"temp\":36.5}",
                0.1 * std::sin(t), 0.1 * std::cos(t), 0.01 * std::sin(t / 2));
  return buf;
}

std::string now_ads_json() {
  double t = std::chrono::duration<double>(
                 std::chrono::steady_clock::now().time_since_epoch())
                 .count();
  char buf[256];
  // schema parity with esp32cam.ino:193-211 (4 single-ended channels)
  std::snprintf(buf, sizeof(buf),
                "{\"ch0\":%.4f,\"ch1\":%.4f,\"ch2\":%.4f,\"ch3\":%.4f}",
                1.65 + 0.5 * std::sin(t), 1.65, 0.33, 0.0);
  return buf;
}

void send_all(int fd, const void* data, size_t n) {
  const char* p = static_cast<const char*>(data);
  while (n > 0) {
    ssize_t w = send(fd, p, n, MSG_NOSIGNAL);
    if (w <= 0) return;
    p += w;
    n -= size_t(w);
  }
}

void http_reply(int fd, const std::string& ctype, const std::string& body) {
  char hdr[256];
  std::snprintf(hdr, sizeof(hdr),
                "HTTP/1.1 200 OK\r\nContent-Type: %s\r\n"
                "Content-Length: %zu\r\nConnection: close\r\n\r\n",
                ctype.c_str(), body.size());
  send_all(fd, hdr, std::strlen(hdr));
  send_all(fd, body.data(), body.size());
}

void handle_client(int fd) {
  char req[2048];
  ssize_t n = recv(fd, req, sizeof(req) - 1, 0);
  if (n <= 0) {
    close(fd);
    return;
  }
  req[n] = 0;
  std::string r(req);
  std::string path = "/";
  size_t sp1 = r.find(' ');
  size_t sp2 = r.find(' ', sp1 + 1);
  if (sp1 != std::string::npos && sp2 != std::string::npos)
    path = r.substr(sp1 + 1, sp2 - sp1 - 1);

  if (path.rfind("/stream", 0) == 0) {
    // MJPEG multipart (esp32cam.ino:70-126)
    const char* hdr =
        "HTTP/1.1 200 OK\r\nContent-Type: multipart/x-mixed-replace;"
        "boundary=frame\r\nConnection: close\r\n\r\n";
    send_all(fd, hdr, std::strlen(hdr));
    for (int i = 0; i < 1000 && g_running; ++i) {
      char part[128];
      std::snprintf(part, sizeof(part),
                    "--frame\r\nContent-Type: image/jpeg\r\n"
                    "Content-Length: %zu\r\n\r\n",
                    sizeof(kJpeg));
      send_all(fd, part, std::strlen(part));
      send_all(fd, kJpeg, sizeof(kJpeg));
      send_all(fd, "\r\n", 2);
      std::this_thread::sleep_for(std::chrono::milliseconds(50));
      // stop when the peer goes away
      char probe;
      if (recv(fd, &probe, 1, MSG_DONTWAIT | MSG_PEEK) == 0) break;
    }
  } else if (path.rfind("/control", 0) == 0) {
    size_t v = path.find("val=");
    if (path.find("var=framesize") != std::string::npos &&
        v != std::string::npos) {
      g_framesize = std::atoi(path.c_str() + v + 4);
      http_reply(fd, "text/plain", "OK");
    } else {
      http_reply(fd, "text/plain", "ERR");
    }
  } else if (path.rfind("/imu_data", 0) == 0) {
    http_reply(fd, "application/json", now_imu_json());
  } else if (path.rfind("/ads_data", 0) == 0) {
    http_reply(fd, "application/json", now_ads_json());
  } else if (path.rfind("/events", 0) == 0) {
    // SSE combined stream (esp32cam.ino:214-269)
    const char* hdr =
        "HTTP/1.1 200 OK\r\nContent-Type: text/event-stream\r\n"
        "Cache-Control: no-cache\r\nConnection: keep-alive\r\n\r\n";
    send_all(fd, hdr, std::strlen(hdr));
    for (int i = 0; i < 2000 && g_running; ++i) {
      std::string ev = "data: {\"imu\":" + now_imu_json() +
                       ",\"ads\":" + now_ads_json() + "}\n\n";
      send_all(fd, ev.data(), ev.size());
      std::this_thread::sleep_for(std::chrono::milliseconds(100));
      char probe;
      if (recv(fd, &probe, 1, MSG_DONTWAIT | MSG_PEEK) == 0) break;
    }
  } else if (path.rfind("/status", 0) == 0) {
    char buf[64];
    std::snprintf(buf, sizeof(buf), "{\"framesize\":%d}", g_framesize.load());
    http_reply(fd, "application/json", buf);
  } else {
    http_reply(fd, "text/plain", "camera_sim");
  }
  close(fd);
}

}  // namespace

int main(int argc, char** argv) {
  int port = 81;
  for (int i = 1; i < argc - 1; ++i)
    if (!std::strcmp(argv[i], "--port")) port = std::atoi(argv[i + 1]);
  signal(SIGPIPE, SIG_IGN);
  int s = socket(AF_INET, SOCK_STREAM, 0);
  int one = 1;
  setsockopt(s, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = INADDR_ANY;
  addr.sin_port = htons(port);
  if (bind(s, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0) {
    perror("bind");
    return 1;
  }
  listen(s, 8);
  std::printf("camera_sim on :%d\n", port);
  std::fflush(stdout);
  while (g_running) {
    int fd = accept(s, nullptr, nullptr);
    if (fd < 0) continue;
    std::thread(handle_client, fd).detach();
  }
  return 0;
}
