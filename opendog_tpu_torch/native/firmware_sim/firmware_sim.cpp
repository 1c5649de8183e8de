// firmware_sim — loopback ESP32 motor-controller firmware simulator (C++).
//
// Implements the exact UDP/JSON wire protocol of the reference motor
// firmware (reference: Code/esp32_motors.ino):
//   * command vocabulary on the UDP port: set_angles, set_control_params,
//     set_all_pins, set_control_status, reset_all, get_imu_data,
//     set_send_interval  (ino:395-421), each ACKed with {"status":"OK"}
//     (ino:422-428);
//   * a 500 Hz (dt = 2 ms, ino:35) position-PID servo loop per motor with
//     the firmware's dead-zone / scaled-P / boosted-D power law
//     (computePower, ino:131-144) and integral clamping (controlMotor,
//     ino:146-164), driving a first-order brushed-DC motor model with
//     quadrature-encoder resolution of 1975 counts/rev (ino:32);
//   * periodic JSON telemetry (default 50 ms, runtime settable,
//     ino:435-478): angles/encoderPos/targetPos/esp_control_fully_enabled/
//     dmp_ready + dmp_data {quaternion, world_accel_mps2, ypr_deg}.
//
// This is the "fake ESP endpoint" the reference never had (SURVEY §4):
// the Python SDK's tests run against two of these on loopback.
//
// Build: opendog_tpu_torch/native/build.py at first use (g++ -O2 -pthread),
//        or make
// Usage: firmware_sim [--port N] [--telemetry-port N] [--telemetry-ip A]

#include <arpa/inet.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <cctype>
#include <chrono>
#include <cmath>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int kNumMotors = 4;
constexpr double kCountsPerRev = 1975.0;  // ino:32
constexpr double kDtMs = 2.0;             // ino:35
constexpr int kMaxPower = 255;            // ino:29

// ---------------------------------------------------------------------------
// Minimal JSON helpers for the fixed command schema (tolerant, not general).
// ---------------------------------------------------------------------------

bool find_key(const std::string& s, const std::string& key, size_t* pos) {
  std::string pat = "\"" + key + "\"";
  size_t p = s.find(pat);
  if (p == std::string::npos) return false;
  p = s.find(':', p + pat.size());
  if (p == std::string::npos) return false;
  *pos = p + 1;
  return true;
}

bool get_number(const std::string& s, const std::string& key, double* out) {
  size_t p;
  if (!find_key(s, key, &p)) return false;
  try {
    *out = std::stod(s.substr(p));
  } catch (...) {
    return false;
  }
  return true;
}

bool get_string(const std::string& s, const std::string& key,
                std::string* out) {
  size_t p;
  if (!find_key(s, key, &p)) return false;
  size_t q1 = s.find('"', p);
  if (q1 == std::string::npos) return false;
  size_t q2 = s.find('"', q1 + 1);
  if (q2 == std::string::npos) return false;
  *out = s.substr(q1 + 1, q2 - q1 - 1);
  return true;
}

bool get_array(const std::string& s, const std::string& key,
               std::vector<double>* out) {
  size_t p;
  if (!find_key(s, key, &p)) return false;
  size_t b1 = s.find('[', p);
  if (b1 == std::string::npos) return false;
  size_t b2 = s.find(']', b1);
  if (b2 == std::string::npos) return false;
  out->clear();
  std::string body = s.substr(b1 + 1, b2 - b1 - 1);
  size_t start = 0;
  while (start < body.size()) {
    size_t comma = body.find(',', start);
    std::string tok = body.substr(
        start, comma == std::string::npos ? std::string::npos : comma - start);
    try {
      out->push_back(std::stod(tok));
    } catch (...) {
    }
    if (comma == std::string::npos) break;
    start = comma + 1;
  }
  return true;
}

// ---------------------------------------------------------------------------
// Motor + servo state (mirrors the firmware's Motor struct, ino:41-56)
// ---------------------------------------------------------------------------

struct Motor {
  long encoder_pos = 0;
  long target_pos = 0;
  long last_error = 0;
  double integral_error = 0.0;
  bool control_enabled = false;
  double velocity_cps = 0.0;  // counts/sec — plant state
  int pins[4] = {0, 0, 0, 0};
};

struct Gains {
  double kp = 0.9, ki = 0.001, kd = 0.3;  // ino:25-27
  int dead_zone = 10, pos_thresh = 5;     // ino:28,30
};

class FirmwareSim {
 public:
  FirmwareSim(int port, const std::string& telemetry_ip, int telemetry_port)
      : port_(port), telemetry_ip_(telemetry_ip),
        telemetry_port_(telemetry_port) {}

  int run() {
    sock_ = socket(AF_INET, SOCK_DGRAM, 0);
    if (sock_ < 0) return 1;
    int one = 1;
    setsockopt(sock_, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    setsockopt(sock_, SOL_SOCKET, SO_BROADCAST, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = INADDR_ANY;
    addr.sin_port = htons(port_);
    if (bind(sock_, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0) {
      perror("bind");
      return 1;
    }
    std::printf("firmware_sim listening on UDP :%d, telemetry -> %s:%d\n",
                port_, telemetry_ip_.c_str(), telemetry_port_);
    std::fflush(stdout);
    running_ = true;
    std::thread control(&FirmwareSim::control_loop, this);
    std::thread telemetry(&FirmwareSim::telemetry_loop, this);
    command_loop();
    running_ = false;
    control.join();
    telemetry.join();
    close(sock_);
    return 0;
  }

 private:
  // ---- firmware power law: computePower (ino:131-144) ----
  int compute_power(const Gains& g, long error, long error_delta) const {
    if (std::labs(error) <= g.dead_zone) return 0;
    double scaled = std::max(-1.0, std::min(1.0, double(error) / g.pos_thresh));
    double dt_sec = kDtMs / 1000.0;
    double p_term = g.kp * scaled * kMaxPower;
    double d_term = g.kd * (error_delta / dt_sec);
    if (std::labs(error) <= g.dead_zone * 5) d_term *= 3.0;
    d_term = std::max(-kMaxPower / 2.0, std::min(kMaxPower / 2.0, d_term));
    double power = p_term + d_term;
    return int(std::max<double>(-kMaxPower, std::min<double>(kMaxPower, power)));
  }

  void control_loop() {
    using clock = std::chrono::steady_clock;
    auto next = clock::now();
    const auto period = std::chrono::microseconds(int(kDtMs * 1000));
    // brushed-DC + gearbox plant: velocity tracks power with a first-order
    // lag; full power ~ 2 rev/s at the output shaft
    const double vel_per_power = 2.0 * kCountsPerRev / kMaxPower;  // cps
    const double tau = 0.05;  // motor time constant [s]
    const double dt = kDtMs / 1000.0;
    while (running_) {
      {
        std::lock_guard<std::mutex> lock(mu_);
        for (auto& m : motors_) {
          int power = 0;
          if (m.control_enabled) {
            long error = m.target_pos - m.encoder_pos;
            long error_delta = error - m.last_error;
            m.last_error = error;
            // integral handling (controlMotor, ino:153-161)
            if (gains_.ki != 0 &&
                std::labs(error) < kMaxPower / std::fabs(gains_.ki)) {
              m.integral_error += error * dt;
            }
            power = compute_power(gains_, error, error_delta) +
                    int(gains_.ki * m.integral_error);
          }
          double target_vel = power * vel_per_power;
          m.velocity_cps += (target_vel - m.velocity_cps) * (dt / tau);
          m.encoder_pos += long(std::lround(m.velocity_cps * dt));
        }
      }
      next += period;
      std::this_thread::sleep_until(next);
    }
  }

  void telemetry_loop() {
    sockaddr_in dst{};
    dst.sin_family = AF_INET;
    dst.sin_port = htons(telemetry_port_);
    inet_pton(AF_INET, telemetry_ip_.c_str(), &dst.sin_addr);
    while (running_) {
      int interval;
      std::string payload;
      {
        std::lock_guard<std::mutex> lock(mu_);
        interval = send_interval_ms_;
        payload = telemetry_json();
      }
      sendto(sock_, payload.data(), payload.size(), 0,
             reinterpret_cast<sockaddr*>(&dst), sizeof(dst));
      std::this_thread::sleep_for(std::chrono::milliseconds(interval));
    }
  }

  std::string telemetry_json() const {
    // schema parity with ino:435-478
    char buf[1024];
    bool all_enabled = true;
    for (const auto& m : motors_)
      if (!m.control_enabled) all_enabled = false;
    std::string angles, enc, tgt;
    for (int i = 0; i < kNumMotors; ++i) {
      char t[64];
      std::snprintf(t, sizeof(t), "%.4f",
                    motors_[i].encoder_pos * 360.0 / kCountsPerRev);
      angles += t;
      std::snprintf(t, sizeof(t), "%ld", motors_[i].encoder_pos);
      enc += t;
      std::snprintf(t, sizeof(t), "%ld", motors_[i].target_pos);
      tgt += t;
      if (i + 1 < kNumMotors) {
        angles += ",";
        enc += ",";
        tgt += ",";
      }
    }
    std::snprintf(
        buf, sizeof(buf),
        "{\"angles\":[%s],\"encoderPos\":[%s],\"targetPos\":[%s],"
        "\"esp_control_fully_enabled\":%s,\"dmp_ready\":true,"
        "\"dmp_data\":{\"quaternion\":{\"w\":1.0,\"x\":0.0,\"y\":0.0,"
        "\"z\":0.0},\"world_accel_mps2\":{\"ax\":0.0,\"ay\":0.0,\"az\":0.0},"
        "\"ypr_deg\":{\"yaw\":%.2f,\"pitch\":0.0,\"roll\":0.0}}}",
        angles.c_str(), enc.c_str(), tgt.c_str(),
        all_enabled ? "true" : "false", sim_yaw_deg_);
    return std::string(buf);
  }

  void command_loop() {
    char buf[2048];
    while (running_) {
      sockaddr_in src{};
      socklen_t slen = sizeof(src);
      ssize_t n = recvfrom(sock_, buf, sizeof(buf) - 1, 0,
                           reinterpret_cast<sockaddr*>(&src), &slen);
      if (n <= 0) continue;
      buf[n] = 0;
      std::string msg(buf);
      std::string cmd;
      if (!get_string(msg, "command", &cmd)) continue;
      handle_command(msg, cmd);
      if (cmd == "get_imu_data") {
        // dmp_status response to the sender BEFORE the OK ack
        // (handle_get_imu_data, ino:264-291)
        std::string imu = imu_response();
        sendto(sock_, imu.data(), imu.size(), 0,
               reinterpret_cast<sockaddr*>(&src), slen);
      }
      // ACK every valid command (ino:422-428)
      const char* ok = "{\"status\":\"OK\"}";
      sendto(sock_, ok, std::strlen(ok), 0,
             reinterpret_cast<sockaddr*>(&src), slen);
      if (cmd == "__shutdown__") {
        running_ = false;
        break;
      }
    }
  }

  void handle_command(const std::string& msg, const std::string& cmd) {
    std::lock_guard<std::mutex> lock(mu_);
    if (cmd == "set_angles") {  // handle_set_angles, ino:174-182
      std::vector<double> angles;
      if (get_array(msg, "angles", &angles)) {
        for (size_t i = 0; i < angles.size() && i < kNumMotors; ++i) {
          motors_[i].target_pos =
              long(int(angles[i]) * kCountsPerRev / 360.0);
        }
      }
    } else if (cmd == "set_control_params") {  // ino:166-172
      double v;
      if (get_number(msg, "P", &v)) gains_.kp = v;
      if (get_number(msg, "I", &v)) gains_.ki = v;
      if (get_number(msg, "D", &v)) gains_.kd = v;
      if (get_number(msg, "dead_zone", &v)) gains_.dead_zone = int(v);
      if (get_number(msg, "pos_thresh", &v)) gains_.pos_thresh = int(v);
    } else if (cmd == "set_all_pins") {  // ino:184-210
      for (int i = 0; i < kNumMotors; ++i) {
        double v;
        char key[16];
        std::snprintf(key, sizeof(key), "ENCODER_A%d", i);
        if (get_number(msg, key, &v)) motors_[i].pins[0] = int(v);
        std::snprintf(key, sizeof(key), "ENCODER_B%d", i);
        if (get_number(msg, key, &v)) motors_[i].pins[1] = int(v);
        std::snprintf(key, sizeof(key), "IN1_%d", i);
        if (get_number(msg, key, &v)) motors_[i].pins[2] = int(v);
        std::snprintf(key, sizeof(key), "IN2_%d", i);
        if (get_number(msg, key, &v)) motors_[i].pins[3] = int(v);
      }
    } else if (cmd == "set_control_status") {
      double motor = -1, status = 0;
      get_number(msg, "motor", &motor);
      get_number(msg, "status", &status);
      if (motor >= 0 && motor < kNumMotors)
        motors_[int(motor)].control_enabled = status != 0;
    } else if (cmd == "reset_all") {  // zero encoders + targets
      for (auto& m : motors_) {
        m.encoder_pos = m.target_pos = m.last_error = 0;
        m.integral_error = 0;
        m.velocity_cps = 0;
      }
    } else if (cmd == "set_send_interval") {
      double v;
      if (get_number(msg, "interval", &v) && v > 0)
        send_interval_ms_ = int(v);
    }
    // get_imu_data answered in command_loop (polled dmp_status response);
    // the periodic telemetry broadcast carries the same dmp_data
  }

  std::string imu_response() {
    // handle_get_imu_data schema (ino:264-291); the sim's DMP is always
    // "ready" with an identity quaternion + the scripted yaw
    std::lock_guard<std::mutex> lock(mu_);
    char buf[512];
    std::snprintf(
        buf, sizeof(buf),
        "{\"dmp_data\":{\"quaternion\":{\"w\":1.0,\"x\":0.0,\"y\":0.0,"
        "\"z\":0.0},\"world_accel_mps2\":{\"ax\":0.0,\"ay\":0.0,\"az\":0.0},"
        "\"ypr_deg\":{\"yaw\":%.2f,\"pitch\":0.0,\"roll\":0.0}},"
        "\"dmp_status\":\"ready\"}",
        sim_yaw_deg_);
    return std::string(buf);
  }

  int port_;
  std::string telemetry_ip_;
  int telemetry_port_;
  int sock_ = -1;
  std::atomic<bool> running_{false};
  std::mutex mu_;
  Motor motors_[kNumMotors];
  Gains gains_;
  int send_interval_ms_ = 50;  // ino:369
  double sim_yaw_deg_ = 0.0;
};

}  // namespace

int main(int argc, char** argv) {
  int port = 12345;
  std::string tip = "127.0.0.1";
  int tport = 12345;
  for (int i = 1; i < argc - 1; ++i) {
    if (!std::strcmp(argv[i], "--port")) port = std::atoi(argv[i + 1]);
    if (!std::strcmp(argv[i], "--telemetry-port"))
      tport = std::atoi(argv[i + 1]);
    if (!std::strcmp(argv[i], "--telemetry-ip")) tip = argv[i + 1];
  }
  return FirmwareSim(port, tip, tport).run();
}
